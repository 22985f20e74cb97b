"""Device timing on a CUDA card, and the program's spans.

The port's counterpart of ``tpu3dssf.utils.timing``: the median of a
callable between CUDA events (:func:`cuda_ms`, the port's ``time_device``,
over the samples of :func:`cuda_times`), the device time of each CUDA
kernel a callable launches (:func:`profile_kernels`) and the peak
allocated device memory (:func:`peak_hbm_mb`). The JAX module's
``chained_slope``, ``program_peak_mb`` and ``hbm_squeeze`` work around a
TPU runtime without memory statistics and have no counterpart.

Spans (:func:`span`) name the stages of the program from inside it: the
encode, the forward and its stages, the loss, the backward and the
optimizer, the replays and captures of :mod:`tpu3dssf_torch.train.graph`
and the batch's copy to the card. They are off unless
:func:`enable_spans` turned them on; off, :func:`span` returns one shared
null context (no event, no profiler range, no allocation), so a CUDA graph
captured with spans off holds exactly the nodes it would hold without
them. On, a span opens a ``torch.profiler.record_function`` range
``tpu3dssf::<name>`` (the program's ranges on the profiler's clock) and
times itself: on a CUDA tensor by a pair of timing CUDA events on the
current stream (``external`` ones, so that a capture turns them into
event-record nodes of the graph, which every replay records anew), else by
the host's ``time.perf_counter``. A graph's spans are read after each
replay, before the graph's next replay re-records them
(:func:`read_spans`, :func:`replayed_spans`); a read that has to wait for
the card counts in ``span_waits``. Spans nest: each record keeps its name,
its parent (the innermost open span on the same clock), its frame (one
call of a :class:`~tpu3dssf_torch.train.graph.GraphedStep`, one replay,
or else one root span) and its milliseconds. :func:`span_summary` sums
them by name; :func:`span_counters` gives the counters that the program's
layers add to with :func:`count` (this module imports none of them) since
the last :func:`reset_spans`.
"""

from __future__ import annotations

import contextlib
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


# ---- spans -------------------------------------------------------------

_ON = False
_NULL = contextlib.nullcontext()
_RECORDS: list = []        # every span of this generation, in entry order
_PENDING: list = []        # device records whose events are not read yet
_STACK: list = []          # the open spans
_CAPTURE = None            # the span layout of the graph being captured
_FRAME = None              # the frame of the GraphedStep call under way
_GEN = 0                   # bumped by reset_spans
_NEXT_FRAME = 0
_COUNTS: dict = {}


def enable_spans(on: bool = True):
    """Turn spans on or off for this process (off at import). A graph
    captured while they were off has no span in it."""
    global _ON
    _ON = bool(on)


def spans_enabled() -> bool:
    return _ON


class _Record:
    __slots__ = ("name", "parent", "frame", "clock", "ms", "start", "end",
                 "gen")

    def __init__(self, name, parent, frame, clock, start=None, end=None):
        self.name, self.parent, self.frame, self.clock = (name, parent,
                                                          frame, clock)
        self.start, self.end, self.ms, self.gen = start, end, None, _GEN


def _new_frame():
    global _NEXT_FRAME
    _NEXT_FRAME += 1
    return _NEXT_FRAME


def _parent(layout, clock):
    """The index of the innermost open span kept in ``layout`` (the
    records, or a capture's layout) on ``clock``."""
    return next((s.index for s in reversed(_STACK)
                 if s.layout is layout and s.clock == clock), None)


class _Span:
    __slots__ = ("name", "clock", "range", "layout", "index", "item")

    def __init__(self, name, clock):
        self.name, self.clock = name, clock

    def __enter__(self):
        self.range = torch.profiler.record_function("tpu3dssf::" + self.name)
        self.range.__enter__()
        self.layout, self.index, self.item = None, None, None
        if self.clock == "device" and torch.cuda.is_current_stream_capturing():
            # event-record nodes of the graph, read after each replay; a
            # capture that keeps no layout (not a GraphedStep's) gets none
            if _CAPTURE is not None:
                start = torch.cuda.Event(enable_timing=True, external=True)
                self.item = [self.name, _parent(_CAPTURE, "device"), start,
                             None]
                self.layout, self.index = _CAPTURE, len(_CAPTURE)
                _CAPTURE.append(self.item)
                start.record()
        else:
            parent = _parent(_RECORDS, self.clock)
            fr = (_FRAME if _FRAME is not None
                  else _RECORDS[parent].frame if parent is not None
                  else _new_frame())
            self.item = _Record(self.name, parent, fr, self.clock)
            self.layout, self.index = _RECORDS, len(_RECORDS)
            _RECORDS.append(self.item)
            if self.clock == "device":
                self.item.start = torch.cuda.Event(enable_timing=True)
                self.item.start.record()
            else:
                self.item.start = time.perf_counter()
        _STACK.append(self)
        return self

    def __exit__(self, *exc):
        _STACK.pop()
        item = self.item
        if isinstance(item, list):                # a captured span
            item[3] = torch.cuda.Event(enable_timing=True, external=True)
            item[3].record()
        elif item is not None and self.clock == "device":
            item.end = torch.cuda.Event(enable_timing=True)
            item.end.record()
            _PENDING.append(item)
        elif item is not None:
            item.ms = (time.perf_counter() - item.start) * 1e3
        self.range.__exit__(*exc)
        return False


def span(name: str, on=None):
    """A context manager naming a stage ``name``: the shared null context
    while spans are off; on, a ``tpu3dssf::<name>`` profiler range timed
    on the card where ``on`` (a tensor or device) is a CUDA one, else on
    the host."""
    if not _ON:
        return _NULL
    dev = getattr(on, "device", on)
    cuda = dev is not None and torch.device(dev).type == "cuda"
    return _Span(name, "device" if cuda else "host")


class _Frame:
    __slots__ = ()

    def __enter__(self):
        global _FRAME
        _FRAME = _new_frame()

    def __exit__(self, *exc):
        global _FRAME
        _FRAME = None
        return False


def frame():
    """A context in which every span shares one new frame (a call of a
    graphed step); the shared null context while spans are off or a frame
    is under way."""
    return _Frame() if _ON and _FRAME is None else _NULL


@contextlib.contextmanager
def capture_spans():
    """Collects the layout of the spans a CUDA graph capture records:
    ``[name, parent index, start event, end event]`` each."""
    global _CAPTURE
    outer, _CAPTURE = _CAPTURE, []
    try:
        yield _CAPTURE
    finally:
        _CAPTURE = outer


def replayed_spans(layout):
    """Records of the spans of a replay just enqueued, in the current
    frame; returns them to be read (:func:`read_spans`) before the graph's
    next replay."""
    if not _ON or not layout:
        return []
    fr = _FRAME if _FRAME is not None else _new_frame()
    base = len(_RECORDS)
    out = []
    for name, parent, start, end in layout:
        rec = _Record(name, None if parent is None else base + parent, fr,
                      "device", start, end)
        _RECORDS.append(rec)
        out.append(rec)
    _PENDING.extend(out)
    return out


def read_spans(records):
    """Milliseconds of each device record from its events; a record whose
    end the card has not reached yet waits for it and counts in
    ``span_waits``."""
    for rec in records:
        if rec.ms is not None or rec.gen != _GEN:
            continue
        if not rec.end.query():
            count("span_waits")
            rec.end.synchronize()
        rec.ms = rec.start.elapsed_time(rec.end)
        rec.start = rec.end = None


def count(name: str, amount: int = 1):
    """Adds ``amount`` to the counter ``name`` while spans are on."""
    if _ON:
        _COUNTS[name] = _COUNTS.get(name, 0) + amount


def reset_spans():
    """Drops every record and restarts the counters (graphs keep their
    span layouts: their next replays are recorded anew)."""
    global _RECORDS, _PENDING, _GEN
    _GEN += 1
    _RECORDS, _PENDING = [], []
    _COUNTS.clear()


def span_counters() -> dict:
    """The counters (:func:`count`) since the last :func:`reset_spans`:
    reads that waited (``span_waits``, 0 where none did), graphs captured
    and replayed (``graph_captures``, ``graph_replays``) and the batch's
    copies (``batch_to_device.tensors``, ``.bytes``)."""
    return {"span_waits": 0, **_COUNTS}


def span_summary() -> dict:
    """``{name: {"clock", "count", "ms", "self_ms", "frames"}}`` over the
    records since the last :func:`reset_spans`: the calls, their
    milliseconds in all, the same less their children's (on the same
    clock) and the frames they ran in. Reads every pending device record
    first."""
    read_spans(list(_PENDING))
    _PENDING.clear()
    child_ms = [0.0] * len(_RECORDS)
    for rec in _RECORDS:
        if rec.parent is not None and rec.ms is not None:
            child_ms[rec.parent] += rec.ms
    out: dict = {}
    for i, rec in enumerate(_RECORDS):
        if rec.ms is None:          # still open
            continue
        s = out.setdefault(rec.name, {"clock": rec.clock, "count": 0,
                                      "ms": 0.0, "self_ms": 0.0,
                                      "frames": set()})
        s["count"] += 1
        s["ms"] += rec.ms
        s["self_ms"] += rec.ms - child_ms[i]
        s["frames"].add(rec.frame)
    for s in out.values():
        s["frames"] = len(s["frames"])
    return out


def span_records():
    """The records since the last :func:`reset_spans`, pending ones read:
    ``(name, parent index or None, frame, clock, ms)`` each."""
    span_summary()
    return [(r.name, r.parent, r.frame, r.clock, r.ms) for r in _RECORDS]
