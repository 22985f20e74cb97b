"""The fusion train step and batch of one checkout, eager and graphed, on
the card.

    python3 tpu3dssf_torch/cli/time_train_step.py [--root DIR] [--out FILE]
    python3 tpu3dssf_torch/cli/time_train_step.py --ab OLD_ROOT [--out FILE]

Runs chip_smoke's phase 23 (``run_graph_train``) of the checkout under
``--root`` (default: the one holding this file), with that checkout's own
package and kernels: the full-width train step of
``configs/synthetic_convergence_fusion_r3.yaml`` (ViT-S/16 encode, PTv3,
fusion head, loss, backward, AdamW), eager and graphed: CUDA-event medians
of 10 frames each, eager, graphed, graphed, eager; the profiler's device
time of a frame of each; peak allocated memory; and the graphed steps held
against the eager ones; then phase 22's fusion batch (ViT-S encode + eval
step, as ``main_infer`` runs it) likewise: the same medians, device time
and peak memory. It builds the checkout's kernel sources first, one nvcc
each, all started together.

``--ab OLD_ROOT`` runs it on OLD_ROOT (an unpacked older commit, e.g.
``git archive`` of the parent into ``build/parent``), this checkout, this
checkout and OLD_ROOT, each in its own process, so that two versions of
the step are compared on one card in turns, and prints the medians side
by side. Run it by path, not with ``-m``, so that the package is imported
from ``--root``. Prints the card line and one JSON object, which ``--out``
also writes to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def time_root(root):
    """Phase 23's row of the checkout under ``root``."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_train_step.py: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from tpu3dssf_torch.kernels import _build
    if hasattr(_build, "load_cuda_library"):
        _build.load_cuda_library()     # built at import: raises a failure
    else:   # a checkout from before the C++ op library
        with ThreadPoolExecutor(max_workers=len(chip_smoke.SOURCES)) as pool:
            list(pool.map(_build.load_library, chip_smoke.SOURCES))
    card = chip_smoke.card_line()
    row, _ = chip_smoke.run_graph_train(card)
    from tpu3dssf_torch.cli.common import load_config
    path = chip_smoke.eval_path("fusion", load_config(chip_smoke.CONFIG),
                                torch.device("cuda"))
    batch = chip_smoke.ab_time("fusion", path["eager"], path["graphed"],
                               path["points"], card)
    del path
    return dict(root=root, card=card, torch=torch.__version__,
                fusion_batch={k: batch[k] for k in (
                    "runs", "device", "peak_eager_bytes",
                    "peak_graphed_bytes")},
                runs=row["runs"], device=row["device"],
                peak_eager_bytes=row["peak_eager_bytes"],
                peak_graphed_bytes=row["peak_graphed_bytes"],
                points=row["points"], params_diff=row["params_diff"])


def run_ab(old):
    runs = []
    for root in (old, HERE, HERE, old):
        with tempfile.NamedTemporaryFile(suffix=".json") as f:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--root", root, "--out", f.name], check=True)
            runs.append(json.load(open(f.name)))
    order = ["old" if r["root"] != HERE else "new" for r in runs]
    ms = {tag: [r["runs"][tag]["ms"] for r in runs]
          for tag in ("eager", "graphed", "graphed_2", "eager_2")}
    device_ms = {tag: [r["device"][tag]["ms"] for r in runs]
                 for tag in ("eager", "graphed")}
    batch_ms = {tag: [r["fusion_batch"]["runs"][tag]["ms"] for r in runs]
                for tag in ("eager", "graphed", "graphed_2", "eager_2")}
    spread = {"batch_graphed": [r["fusion_batch"]["runs"]["graphed"][
        "spread"] for r in runs],
        "train_graphed": [r["runs"]["graphed"]["spread"] for r in runs]}
    return dict(order=order, old=old, new=HERE, ms=ms, device_ms=device_ms,
                batch_ms=batch_ms, spread=spread, card=runs[0]["card"],
                runs=runs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose train step is timed")
    ap.add_argument("--ab", metavar="OLD_ROOT",
                    help="time OLD_ROOT, this checkout twice, OLD_ROOT")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    if args.ab:
        result = run_ab(os.path.abspath(args.ab))
        print(result["card"])
        print("ab " + json.dumps({k: result[k] for k in (
            "order", "ms", "device_ms", "batch_ms", "spread")}))
    else:
        result = time_root(os.path.abspath(args.root))
        print(result["card"])
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main()
