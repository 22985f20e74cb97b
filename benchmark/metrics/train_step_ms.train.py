"""Milliseconds a step of the graphed train step: forward, loss, backward,
AdamW (CUDA events)."""

from benchmark.harness import readers


def read(run):
    return readers.span_ms(run, "train", "step")
