"""Milliseconds a step of the batch's and images' copy to the card (CUDA
events)."""

from benchmark.harness import readers


def read(run):
    return readers.span_ms(run, "train", "h2d")
