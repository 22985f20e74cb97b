"""Milliseconds a batch of the graphed eval step (CUDA events)."""

from benchmark.harness import readers


def read(run):
    return readers.span_ms(run, "eval", "forward")
