"""Device timing on a CUDA card.

The port's counterpart of ``tpu3dssf.utils.timing``, reduced to what the
port measures today: the median of a callable between CUDA events, and
the device time of each CUDA kernel a callable launches.
"""

from __future__ import annotations

import torch


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, after
    ``warmup`` untimed calls; synchronises after every call."""
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
    return sorted(times)[len(times) // 2]


def profile_kernels(fn, reps: int = 3):
    """Run ``fn()`` once untimed, then ``reps`` times under
    ``torch.profiler``.

    Returns ``(prof, kernels)``: the profiler, and for every CUDA kernel
    ``{name: (device µs per call of fn, launches per call of fn)}``. User
    annotations (``record_function`` ranges), which the profiler also puts
    on the device timeline, are left out.
    """
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: (e.self_device_time_total / reps, e.count / reps)
               for e in prof.key_averages()
               if e.device_type.name == "CUDA" and not e.is_user_annotation}
    return prof, kernels
