"""Milliseconds a frame of the graphed forward and argmax (CUDA events)."""

from benchmark.harness import readers


def read(run):
    return readers.span_ms(run, "stream", "forward")
