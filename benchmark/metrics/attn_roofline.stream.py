"""Attention kernels' share of their roofline in the traced window, in %."""

from benchmark.harness import readers


def read(run):
    return readers.roofline_pct(run, "stream", "attention", run.work.attn_s)
