"""Device time of the k-NN kernel K7 at the call shapes of the parity path.

    python3 tpu3dssf_torch/cli/time_knn.py [--root DIR] [--out FILE]
    python3 tpu3dssf_torch/cli/time_knn.py --ab OLD_ROOT [--out FILE]

Times ``knn.knn`` of the ``tpu3dssf_torch`` package under ``--root``
(default: the checkout holding this file) on the inputs of the first test
batch of ``configs/synthetic_convergence_lidar_parity.yaml`` (B = 4, 34,816
points and voxel slots): the knn5 intensity transfer (centroids → points,
k = 5) and the nearest devoxelization (points → centroids, k = 1), and a
ragged case (B = 3, Q = 1000, R = 2501, k = 8, 20% of the refs masked).
Each row has the profiler's device time of one call (``device_ms``, every
device kernel the call runs, by ``chip_smoke.device_time``) and the
kernels' names and counts, the CUDA-event median of the call, whether it
is bit-identical to the plain version (``topk_neighbors_reference``), the
bound (``chip_smoke.knn_bound``) and the issue floor
(``chip_smoke.knn_issue_floor``); the parity rows also time
``torch.cdist(q, r).topk(k)`` (the library call). ``per_batch`` sums the
two parity calls. Where ``--root`` is this checkout, ``sass`` gives the
static instruction mix of the scan's loop over a full tile, per (query,
ref) pair, for k = 5 and k = 1, from ``cuobjdump -sass`` of the built
library.

``--ab OLD_ROOT`` runs this script on OLD_ROOT (an unpacked older commit,
e.g. ``git archive`` of the parent into ``build/parent``), this checkout,
this checkout and OLD_ROOT, each in its own process, so that two versions
are compared on one card in turns, and prints each run's rows and the
device times side by side. Run it by path, not with ``-m``, so that the
package is imported from ``--root``. Prints the card line and one JSON
object, which ``--out`` also writes to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# opcode classes of the scan's loop (SASS mnemonics before the first dot)
CLASSES = {
    "distance": ("FMUL", "FADD", "FFMA"),
    "compare": ("FSETP", "FMNMX"),
    "insert": ("FSEL", "SEL", "MOV", "IMAD", "IADD3", "ISETP", "PLOP3"),
    "shared load": ("LDS",),
    "branch": ("BRA", "BSSY", "BSYNC", "WARPSYNC"),
}


def load_chip_smoke():
    """chip_smoke.py of this checkout (not of ``--root``) as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loop_mix(sass, k, G):
    """Per (query, ref) pair, the opcodes of ``knn_kernel<k, G>``'s loop
    over a full tile: of the loops (backward branches) that read refs from
    shared memory (one ``LDS`` a ref, G pairs each), the one with the
    fewest instructions a pair, by class of :data:`CLASSES` ("other" for
    the rest). Static counts: the insert class runs only where a ref
    enters."""
    funcs = re.split(r"Function : ", sass)
    body = next(f for f in funcs
                if f"knn_kernelILi{k}ELi{G}E" in f.split("\n", 1)[0])
    code = []                           # (address, opcode, text)
    for at, text in re.findall(r"/\*([0-9a-f]+)\*/\s+([^;/]*);", body):
        text = re.sub(r"^@!?U?P[T0-9]+\s+", "", text.strip())
        code.append((int(at, 16), text.split()[0], text))
    best = None
    for at, op, text in code:
        target = re.search(r"0x([0-9a-f]+)\s*$", text)
        if op != "BRA" or not target or int(target.group(1), 16) >= at:
            continue
        loop = [c for c in code if int(target.group(1), 16) <= c[0] <= at]
        pairs = G * sum(1 for c in loop if c[1].startswith("LDS"))
        if pairs and (best is None
                      or len(loop) / pairs < len(best[1]) / best[0]):
            best = (pairs, [c[1] for c in loop])
    if best is None:
        return None
    pairs, ops = best
    mix = {name: 0 for name in list(CLASSES) + ["other"]}
    for op in ops:
        base = op.split(".")[0]
        mix[next((c for c, names in CLASSES.items() if base in names),
                 "other")] += 1
    return dict(pairs_in_loop=pairs, instructions=len(ops),
                per_pair={c: n / pairs for c, n in mix.items()},
                per_pair_total=len(ops) / pairs)


def sass_mix(knn):
    """``loop_mix`` at k = 5 and k = 1 of the library that holds K7: the
    CUDA op library, or in a checkout from before it (no
    ``cuda_library_path``) ``knn.cu``'s own."""
    from tpu3dssf_torch.kernels import _build
    from pathlib import Path
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    lib = (_build.cuda_library_path() if hasattr(_build, "cuda_library_path")
           else _build.library_path(knn._SOURCE))
    sass = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return {f"k{k}": loop_mix(sass, k, G) for k, G in ((5, 4), (1, 8))}


def time_root(root):
    """The rows of the package under ``root`` (see the module docstring)."""
    sys.path.insert(0, root)
    import torch
    from tpu3dssf_torch.kernels import knn
    from tpu3dssf_torch.utils import cuda_ms
    from tpu3dssf_torch.voxel.voxelize import topk_neighbors_reference

    if not os.path.abspath(knn.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {knn.__file__}, not the package under "
                         f"{root}: run this file by path")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = load_chip_smoke()
    card = cs.card_line()
    print(card, flush=True)
    pts, pmask, cents, vmask = cs.parity_batch_inputs()
    gen = torch.Generator().manual_seed(7)
    rq = (torch.rand(3, 1000, 3, generator=gen) * 120 - 60).cuda()
    rr = (torch.rand(3, 2501, 3, generator=gen) * 120 - 60).cuda()
    rm = (torch.rand(3, 2501, generator=gen) > 0.2).cuda()
    calls = {"knn5": (cents, pts, pmask, 5), "nearest": (pts, cents, vmask, 1),
             "ragged": (rq, rr, rm, 8)}
    rows = {}
    for name, (q, r, m, k) in calls.items():
        got = knn.knn(q, r, m, k)
        torch.cuda.synchronize()
        want = topk_neighbors_reference(q, r, m, k)
        ms, kernels = cs.device_time(lambda: knn.knn(q, r, m, k))
        bound, by = cs.knn_bound(q, r, m, k)
        row = dict(B=q.shape[0], Q=q.shape[1], R=r.shape[1], k=k,
                   device_ms=ms, kernels={n[:90]: c for n, c in
                                          kernels.items()},
                   event_ms=cuda_ms(lambda: knn.knn(q, r, m, k)),
                   bit_identical=bool(torch.equal(got[0], want[0])
                                      and torch.equal(got[1], want[1])),
                   bound_ms=bound, bound_by=by,
                   issue_floor_ms=cs.knn_issue_floor(q, r, m))
        if name != "ragged":
            row["cdist_topk_ms"] = cuda_ms(cs.cdist_topk(q, r, m, k),
                                           reps=5, warmup=1)
        print(f"{name} {json.dumps(row)}", flush=True)
        rows[name] = row
        del got, want
        torch.cuda.empty_cache()
    parity = [rows["knn5"], rows["nearest"]]
    recorded = all(r["device_ms"] is not None for r in parity)
    result = dict(root=root, card=card, rows=rows, per_batch=dict(
        device_ms=(sum(r["device_ms"] for r in parity) if recorded
                   else None),
        bound_ms=sum(r["bound_ms"] for r in parity),
        issue_floor_ms=sum(r["issue_floor_ms"] for r in parity),
        cdist_topk_ms=sum(r["cdist_topk_ms"] for r in parity)))
    if root == HERE:
        result["sass"] = sass_mix(knn)
    return result


def run_ab(old):
    """This script on ``old``, here, here, ``old``; each run's result and
    the device times of each shape in that order."""
    runs = []
    for root in (old, HERE, HERE, old):
        with tempfile.NamedTemporaryFile(suffix=".json") as f:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--root", root, "--out", f.name], check=True)
            runs.append(json.load(open(f.name)))
    order = ["old" if r["root"] != HERE else "new" for r in runs]
    side = {name: [r["rows"][name]["device_ms"] for r in runs]
            for name in runs[0]["rows"]}
    side["per_batch"] = [r["per_batch"]["device_ms"] for r in runs]
    return dict(order=order, old=os.path.abspath(old), new=HERE,
                device_ms=side, runs=runs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose tpu3dssf_torch is timed")
    ap.add_argument("--ab", metavar="OLD_ROOT",
                    help="time OLD_ROOT, this checkout twice, OLD_ROOT")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    if args.ab:
        result = run_ab(os.path.abspath(args.ab))
        print("ab " + json.dumps(dict(order=result["order"],
                                      device_ms=result["device_ms"])))
    else:
        result = time_root(os.path.abspath(args.root))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
