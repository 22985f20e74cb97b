"""Device kernels a train step in the traced window."""

from benchmark.harness import readers


def read(run):
    return readers.launches_per_frame(run, "train")
