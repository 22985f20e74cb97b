"""Device kernels a frame in the traced window."""

from benchmark.harness import readers


def read(run):
    return readers.launches_per_frame(run, "stream")
