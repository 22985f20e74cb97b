"""Run one cell of the benchmark once on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``
(with ``busy_s`` and ``window_s`` when traced), ``breakdown`` when
traced, and last ``checks``: each compared number beside its limit, which
also close standard error. Exits non-zero, with no result, where there is
no CUDA card or fewer than the cell asks for, where a file the cell names
or the program is missing, and where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds and compiles; no library loads JAX
CACHE = os.path.join(CHECKOUT, "build", "benchmark_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"
sys.path.insert(0, CHECKOUT)

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu3dssf")


def forbidden_modules():
    """Loaded modules whose top-level name (whole) is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import importlib.util

    from benchmark.harness import spec
    cell = spec.Cell(args.workload, spec.benchmark())
    if importlib.util.find_spec("tpu3dssf_torch") is None:
        print("[bench] the program (tpu3dssf_torch) is not in this checkout",
              file=sys.stderr)
        return 2

    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[bench] this cell needs {chips} CUDA card(s); found {found} "
              "(the benchmark never runs on the CPU)", file=sys.stderr)
        return 2

    from benchmark.harness import cells
    result, _, _ = cells.run(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             T_START)
    bad = forbidden_modules()
    if bad:
        print(f"[bench] loaded in this process: {bad}; the benchmark runs "
              "the PyTorch port alone", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
