"""Milliseconds a step of the frozen ViT's graphed encode of 72 images
(CUDA events)."""

from benchmark.harness import readers


def read(run):
    return readers.span_ms(run, "train", "encode")
