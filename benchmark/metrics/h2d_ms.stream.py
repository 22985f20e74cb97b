"""Milliseconds a frame of the sweep's and its images' copy to the card
(CUDA events)."""

from benchmark.harness import readers


def read(run):
    return readers.span_ms(run, "stream", "h2d")
