"""The traced window: ``torch.profiler`` over a fixed number of whole
frames or steps, reduced to what the per-layer readers take.

The profiler takes one untraced warm-up frame in its own warm-up step (it
now and then loses the device records at the start of its window), then
the active step of ``frames`` frames, synchronised at both ends. From the
active step's records: every device operation (kernels, copies, memsets)
with its start and length, merged into busy intervals; the window's length
on the host clock; the idle gaps between busy intervals, each named by the
benchmark's host range (``bench::<stage>``) open at the gap's middle.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import torch

_DEVICE_KINDS = ("CUDA",)


@dataclasses.dataclass
class Trace:
    frames: int
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[float, int]]       # name -> (seconds, count)
    gaps: Dict[str, float]                  # host range -> idle seconds

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name matches any of the
        compiled ``patterns``."""
        return sum(s for name, (s, _) in self.ops.items()
                   if any(p.search(name) for p in patterns))

    def launches(self) -> int:
        """Kernels run (copies and memsets left out)."""
        return sum(n for name, (_, n) in self.ops.items()
                   if not _is_copy(name))

    def breakdown(self, top=10):
        ops = sorted(((n, s) for n, (s, _) in self.ops.items()),
                     key=lambda x: -x[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def record(frame: Callable[[], None], frames: int) -> Trace:
    """Profile ``frames`` calls of ``frame`` (each a whole frame or step
    that ends on the host) after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    sched = schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        frame()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        prof.step()
    return reduce(prof.events(), frames, window_s)


def _merge(intervals: List[Tuple[float, float]]):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, frames: int, window_s: float) -> Trace:
    """A :class:`Trace` from the profiler's events (microsecond times)."""
    ops: Dict[str, Tuple[float, int]] = {}
    device, ranges = [], []
    for e in events:
        kind = e.device_type.name
        start, end = e.time_range.start, e.time_range.end
        if kind in _DEVICE_KINDS:
            if e.is_user_annotation:
                continue
            device.append((start, end))
            s, n = ops.get(e.name, (0.0, 0))
            ops[e.name] = (s + (end - start) * 1e-6, n + 1)
        elif e.name.startswith("bench::"):
            ranges.append((start, end, e.name[len("bench::"):]))
    busy = _merge(device)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        name = next((n for s, e, n in ranges if s <= mid <= e), "other")
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) * 1e-6
    return Trace(frames, window_s, busy_s, ops, gaps)
