"""Milliseconds a frame of the frozen ViT's graphed encode (CUDA events)."""

from benchmark.harness import readers


def read(run):
    return readers.span_ms(run, "stream", "encode")
