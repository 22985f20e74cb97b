"""Share of the traced window with no operation on the card, in %."""

from benchmark.harness import readers


def read(run):
    return readers.idle_pct(run, "eval")
