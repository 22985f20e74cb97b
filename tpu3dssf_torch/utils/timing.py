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
