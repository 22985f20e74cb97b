"""Hyperparameter-sweep launcher over the port's ``main_train``: the port of
``scripts/sweep.py`` (the reference's SLURM job array: each array task runs
one line of CLI parameters).

    python -m tpu3dssf_torch.cli.sweep --params sweep.txt \\
        [--index $SLURM_ARRAY_TASK_ID]

Each line of the params file that is neither empty nor a comment (``#``
first) is the argv of one ``python -m tpu3dssf_torch.cli.main_train`` run,
split as a shell would (``shlex``), e.g. ``--config configs/x.yaml``.
``--index`` runs that one line (under a scheduler); without it every line
runs in turn.
"""

from __future__ import annotations

import argparse
import shlex


def read_lines(path):
    """The params file's runs: its lines stripped, empty ones and those
    starting with ``#`` left out."""
    with open(path) as f:
        return [line.strip() for line in f
                if line.strip() and not line.startswith("#")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--params", required=True,
                    help="file with one main_train argv per line")
    ap.add_argument("--index", type=int, default=None,
                    help="line to run (e.g. $SLURM_ARRAY_TASK_ID); "
                         "default: run all lines sequentially")
    args = ap.parse_args(argv)
    lines = read_lines(args.params)

    from tpu3dssf_torch.cli.main_train import main as train_main
    todo = [lines[args.index]] if args.index is not None else lines
    for i, line in enumerate(todo):
        print(f"=== sweep job {args.index if args.index is not None else i}"
              f": {line}")
        train_main(shlex.split(line))


if __name__ == "__main__":
    main()
