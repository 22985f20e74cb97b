"""What the per-layer readers share: each ``metrics/<name>.py`` is a
line or two over these. A reader returns None where its run has nothing
for it to read (another kind of loop, no such span, no such kernel)."""

from __future__ import annotations

import statistics

from benchmark.harness import spec
from benchmark.harness.counts import BF16_FLOPS


def span_ms(run, kind, stage):
    """Mean milliseconds of ``stage`` over the window's frames."""
    ms = run.spans.get(stage) if run.kind == kind else None
    return statistics.fmean(ms) if ms else None


def launches_per_frame(run, kind):
    if run.kind != kind or not run.trace.frames:
        return None
    return run.trace.launches() / run.trace.frames


def roofline_pct(run, kind, layer, bound_s):
    """The least time of the traced frames' problems of ``layer`` over the
    device time of the kernels that its tables name, in %."""
    if run.kind != kind or not bound_s:
        return None
    seconds = run.trace.kernel_seconds(spec.kernel_patterns(layer))
    return 100.0 * bound_s / seconds if seconds else None


def idle_pct(run, kind):
    if run.kind != kind:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run, kind):
    """The traced frames' model FLOPs over the window at the bf16 peak."""
    if run.kind != kind or not run.work.flops:
        return None
    return 100.0 * run.work.flops / (run.trace.window_s * BF16_FLOPS)
