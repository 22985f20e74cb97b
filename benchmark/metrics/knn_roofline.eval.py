"""k-NN kernels' share of their roofline in the traced window, in %."""

from benchmark.harness import readers


def read(run):
    return readers.roofline_pct(run, "eval", "knn", run.work.knn_s)
