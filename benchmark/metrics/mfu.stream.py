"""Model FLOPs of the traced frames over the window at the bf16 peak, in
%."""

from benchmark.harness import readers


def read(run):
    return readers.mfu_pct(run, "stream")
