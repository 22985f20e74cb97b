"""Model FLOPs of the traced steps (frozen ViT forward; the rest forward
and backward) over the window at the bf16 peak, in %."""

from benchmark.harness import readers


def read(run):
    return readers.mfu_pct(run, "train")
