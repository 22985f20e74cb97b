"""Attention kernels' share of their roofline over the traced steps
(forward and backward), in %."""

from benchmark.harness import readers


def read(run):
    return readers.roofline_pct(run, "train", "attention", run.work.attn_s)
