"""Device timing on a CUDA card, and the host-side timers.

The port's counterpart of ``tpu3dssf.utils.timing``: the median of a
callable between CUDA events (:func:`cuda_ms`, the port's ``time_device``,
over the samples of :func:`cuda_times`),
the device time of each CUDA kernel a callable launches
(:func:`profile_kernels`), the peak allocated device memory
(:func:`peak_hbm_mb`), a wall-time and memory snapshot around one call
(:func:`measure_efficiency`) and a rolling per-step wall timer
(:class:`StepTimer`). The JAX module's ``chained_slope``,
``program_peak_mb`` and ``hbm_squeeze`` work around a TPU runtime without
memory statistics and have no counterpart.
"""

from __future__ import annotations

import time

import torch

_MIB = 1024 ** 2


def cuda_times(fn, reps: int = 20, warmup: int = 3):
    """Milliseconds of each of ``reps`` calls of ``fn()`` between CUDA
    events, after ``warmup`` untimed calls; synchronises after every
    call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, after
    ``warmup`` untimed calls (:func:`cuda_times`)."""
    times = cuda_times(fn, reps, warmup)
    return sorted(times)[len(times) // 2]


def profile_kernels(fn, reps: int = 3):
    """Run ``fn()`` once untimed, then under ``torch.profiler``: one call in
    the profiler's own warm-up step and ``reps + 1`` in its active window,
    each in a ``record_function`` range of its own and each followed by a
    synchronisation.

    The profiler now and then loses the device records of the first
    kernels of its active window (more often without the warm-up step), so
    the first active call is a pad and only the last ``reps`` count: every
    kernel that starts on the device after the host opened the first of
    their ranges. The ranges the profiler draws on the device timeline do
    not bound a call: they end at the last kernel tied to the call's ops,
    before the optimizer's ``multi_tensor_apply`` kernels.

    Returns ``(prof, kernels, annotations)``: the profiler; for every CUDA
    kernel ``{name: (device µs per call of fn, launches per call of fn)}``;
    and the same for every ``record_function`` range that ``fn`` opens, as
    the profiler draws it on the device timeline.
    """
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps + 1,
                                   repeat=1)) as prof:
        for i in range(reps + 2):
            with record_function(f"profile_kernels::call{i}"):
                fn()
            torch.cuda.synchronize()
            prof.step()
    events = prof.events()
    opened = [e.time_range.start for e in events
              if e.device_type.name == "CPU"
              and e.name == "profile_kernels::call2"]
    if not opened:
        raise RuntimeError("profiler: no host range of the first measured "
                           "call")
    first = min(opened)
    kernels, annotations = {}, {}
    for e in events:
        if (e.device_type.name != "CUDA" or e.time_range.start < first
                or e.name.startswith("profile_kernels::")):
            continue
        into = annotations if e.is_user_annotation else kernels
        us, n = into.get(e.name, (0.0, 0))
        into[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    per_call = [{k: (us / reps, n / reps) for k, (us, n) in d.items()}
                for d in (kernels, annotations)]
    return (prof, *per_call)


def peak_hbm_mb(device=None) -> float:
    """Peak allocated device memory in MiB since the last
    ``torch.cuda.reset_peak_memory_stats`` (``max_memory_allocated``); 0.0
    on the CPU, as JAX's CPU backend gives no memory statistics."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / _MIB


def measure_efficiency(func, *args, **kwargs):
    """``func(*args, **kwargs)`` with its wall time, closed by a
    ``torch.cuda.synchronize`` where a card is present, and the allocated
    device memory after it: ``(result, {"runtime_sec", "mem_alloc_MB"})``
    (memory 0.0 without a card)."""
    cuda = torch.cuda.is_available()
    t0 = time.perf_counter()
    result = func(*args, **kwargs)
    if cuda:
        torch.cuda.synchronize()
    runtime = time.perf_counter() - t0
    mem_mb = torch.cuda.memory_allocated() / _MIB if cuda else 0.0
    return result, {"runtime_sec": runtime, "mem_alloc_MB": mem_mb}


class StepTimer:
    """Rolling per-step wall-time tracker for train loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_ms(self) -> float:
        return 1e3 * (sum(self._times) / len(self._times)) \
            if self._times else 0.0
