"""Read the compared numbers of a cell over many seeds, the program's and
the control's (the reference on float8 operands in the program's place),
in one process, at the cell's own sizes: the readings the limits under
``limits/`` are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,...
        [--seconds 1] [--fault unchanged|half|alter] [--out FILE]

Each seed is a short run of the cell (the window at the cell's load,
then the check on the run's sampled frames) followed by the control on
the same frames. Prints one JSON line a seed and, last, the largest
program reading and the smallest control reading of each number. With
``--fault`` the program runs with that fault planted
(:mod:`benchmark.harness.faults`) and no control: the fault's readings.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    import argparse

    import torch

    import contextlib

    from benchmark.harness import cells, faults, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", choices=faults.FAULTS)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.Cell(args.workload, spec.benchmark())
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        planted = (faults.plant(args.fault, cell.traffic["loop"])
                   if args.fault else contextlib.nullcontext())
        with planted:
            _, found, ctrl = cells.run(cell, seed, args.seconds, False,
                                       torch.device("cuda", 0),
                                       time.perf_counter(),
                                       control=not args.fault)
        rows.append({"seed": seed, "program": found, "control": ctrl})
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "fault": args.fault,
               "seeds": len(rows),
               "program_max": {k: max(r["program"][k] for r in rows)
                               for k in rows[0]["program"]},
               "program_min": {k: min(r["program"][k] for r in rows)
                               for k in rows[0]["program"]}}
    if not args.fault:
        summary["control_min"] = {k: min(r["control"][k] for r in rows)
                                  for k in rows[0]["control"]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, **summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
