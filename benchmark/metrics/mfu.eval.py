"""Model FLOPs of the traced batches over the window at the bf16 peak,
in %."""

from benchmark.harness import readers


def read(run):
    return readers.mfu_pct(run, "eval")
