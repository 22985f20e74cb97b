"""Milliseconds a batch of the input's copy to the card (CUDA events)."""

from benchmark.harness import readers


def read(run):
    return readers.span_ms(run, "eval", "h2d")
