"""Time isolated pieces of a step on the card: the measurement layer of the
attribution CLIs (``cli/attr_bwd.py``, ``cli/time_ptv3_parts.py``,
``cli/time_block_glue.py``, ``cli/time_loss_parts.py``).

The JAX scripts time each piece with ``time_device``, a two-point slope
over compiled programs. Here a piece ``fn(*args)``, repeated ``r`` times,
is captured as one CUDA graph (:func:`tpu3dssf_torch.train.graph.graphed`,
its first call eager), and its replays are timed between CUDA events
(:func:`tpu3dssf_torch.utils.cuda_times`: the median of ``replays`` after
``warmup``), divided by ``r``: an isolated glue op is 10–20 µs of work,
which an eager call would bury under its launch latency. A replay first
copies the piece's tensor arguments into the graph's own, which the time
includes (spread over the ``r`` repeats). Each row also holds:

* the profiler's device time of one replay over ``r``
  (:func:`replay_kernels`: :func:`tpu3dssf_torch.utils.profile_kernels`,
  then windows of its own; None where the profiler lost every record),
  and whether it and the wall time per repeat differ by more than the
  spread of the replays;
* the host seconds the piece took to capture, time and profile;
* the ``tpu3dssf::`` kernel launches per repeat, from the launch counts of
  the capture, held to the launches the piece must make: its attention's
  (:func:`attention_launches`, the route of
  :func:`tpu3dssf_torch.models.ptv3.attention_route`) and its LayerNorms'
  (:func:`layer_norm_launches`), none for a piece with neither; and the
  D = 16 attention kernels among the
  captured graph's kernel nodes per repeat, held to those launches (one
  forward kernel a K1, K2, K4 or K6 launch, one backward kernel a K3 or
  K5). A count that differs raises.

On the CPU (``--device cpu``: tiny sizes, for tests) a piece runs eagerly
and is timed on the host clock; it has no device time and launches
nothing. Each CLI prints the card line, one row per piece and, as its last
line, one JSON object (:meth:`Pieces.record`), which ``--out`` also
writes.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

# the D = 16 attention kernels as the captured graph's nodes name them
D16_FORWARD = r"fap_fwd_d16_"
D16_BACKWARD = r"fap_bwd_d16_(small_)?kernel"
FORWARD_KERNELS = ("K1", "K2", "K4", "K6")
BACKWARD_KERNELS = ("K3", "K5")
# replay_kernels: calls of a piece in a profiled window, and windows of
# each kind it tries (the profiler now and then loses every record of a
# window of short calls)
PROFILE_CALLS, PROFILE_TRIES = 3, 3


def attention_launches(channels, heads, window, grad):
    """The attention launches of one ``SerializedAttention`` call at
    ``channels``, ``heads`` and ``window``: K1 (packed routes) or K6 (the
    (W, K, H, D) route) without a gradient; K2 and K3 on the packed route,
    K4 and K5 on the others, with one."""
    from tpu3dssf_torch.models.ptv3 import attention_route
    route = attention_route(channels, heads, window)
    if grad:
        return ({"K2": 1, "K3": 1} if route == "packed"
                else {"K4": 1, "K5": 1})
    return {"K6": 1} if route == "window" else {"K1": 1}


def layer_norm_launches(norms, grad):
    """The launches of ``norms`` LayerNorm calls: LN each, and LNB each
    with a gradient."""
    return {k: norms for k in (("LN", "LNB") if grad else ("LN",)) if norms}


def plus(*counts):
    """The sum of launch counts, each {kernel: launches}."""
    out = {}
    for c in counts:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


def fwd_bwd(fn, params, inputs):
    """``fn(*inputs)`` and the gradient of its f32 sum (the JAX scripts'
    ``live``) with respect to ``params`` and every input (each input a
    detached alias that requires grad, so that a graph reads its static
    input in place). Returns (sum, gradients)."""
    xs = [x.detach().requires_grad_(True) for x in inputs]
    value = fn(*xs).float().sum()
    return value, torch.autograd.grad(value, list(params) + xs)


def no_grad(fn):
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


def replay_kernels(fn):
    """{kernel name: (device µs, launches)} per call of ``fn`` from the
    profiler: :func:`tpu3dssf_torch.utils.profile_kernels` over
    PROFILE_CALLS calls, up to PROFILE_TRIES windows while it records no
    device time; then, as often, every device record of a profiled step
    that holds PROFILE_CALLS calls alone (that function keeps only the
    records that start after the host opened a call's range, and late in a
    long process the profiler now and then loses every record of a window
    of short calls); {} where every window lost them."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from tpu3dssf_torch.utils import profile_kernels
    for _ in range(PROFILE_TRIES):
        _, kernels, _ = profile_kernels(fn, reps=PROFILE_CALLS)
        if sum(us for us, _ in kernels.values()) > 0:
            return kernels
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for calls in (1, PROFILE_CALLS):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kernels = {}
        for e in prof.events():
            if e.device_type.name == "CUDA" and not e.is_user_annotation:
                us, n = kernels.get(e.name, (0.0, 0))
                kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        if sum(us for us, _ in kernels.values()) > 0:
            return {k: (us / PROFILE_CALLS, n / PROFILE_CALLS)
                    for k, (us, n) in kernels.items()}
    return {}


def arguments(description, r):
    """The options every attribution CLI takes (``r``: its default
    repeats a piece)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--r", type=int, default=r,
                    help="repeats of a piece in its CUDA graph")
    ap.add_argument("--replays", type=int, default=10,
                    help="timed replays (the median is kept)")
    ap.add_argument("--warmup", type=int, default=3,
                    help="untimed replays before them")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny sizes (for tests on the CPU)")
    ap.add_argument("--out", help="also write the JSON object here")
    return ap


class Pieces:
    """The rows of one CLI run: :meth:`time` measures a piece and keeps
    its row; :meth:`record` is the run's JSON object."""

    def __init__(self, tool, args, unit="ms"):
        from tpu3dssf_torch.cli.common import card_line, resolve_device
        self.tool, self.unit = tool, unit
        self.device = resolve_device(args.device)
        self.cuda = self.device.type == "cuda"
        self.dtype = torch.bfloat16 if self.cuda else torch.float32
        self.r, self.replays, self.warmup = args.r, args.replays, args.warmup
        self.out = args.out
        self.rows = []
        self.card = None
        if self.cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            self.card = card_line()
            print(self.card)
        print(f"{tool}: device {self.device}, dtype "
              f"{str(self.dtype).split('.')[-1]}, r {self.r}, "
              f"{self.replays} replays after {self.warmup}", flush=True)

    def tensor(self, x, dtype=None):
        """A numpy array on the run's device (floats in ``dtype``, default
        the run's compute dtype)."""
        x = torch.as_tensor(np.asarray(x))
        if x.is_floating_point():
            x = x.to(dtype or self.dtype)
        return x.to(self.device)

    def module(self, m, seed=0):
        """A port module with seeded flax-style weights on the device."""
        from tpu3dssf_torch.models.layers import init_weights
        return init_weights(m, seed).to(self.device)

    def time(self, name, fn, *args, r=None, depth=1, launches=None,
             **info):
        """Time ``fn(*args)`` as one piece (the module docstring); its row
        also holds ``depth`` (the times it runs in a step) and ``info``.
        ``launches``: the kernel launches of one call of ``fn`` (None:
        none). Returns the row."""
        r = self.r if r is None else r
        want = dict(launches or {})

        def repeated(*a):
            for _ in range(r):
                fn(*a)

        row = dict(piece=name, r=r, depth=depth, **info)
        if self.cuda:
            row.update(self._on_card(name, repeated, args, r, want))
        else:
            row.update(self._on_host(repeated, args, r))
        self.rows.append(row)
        self._print(row)
        return row

    def _factor(self):
        return 1.0 if self.unit == "ms" else 1e3

    def _on_card(self, name, repeated, args, r, want):
        from tpu3dssf_torch.train.graph import graphed
        from tpu3dssf_torch.utils import cuda_times

        start = time.perf_counter()
        step = graphed(repeated, name, nodes=True)
        step(*args)                                 # eager, then captured
        graph = next(iter(step.graphs.values()))
        per = {k: n / r for k, n in graph.launches.items() if n}
        nodes = {"forward": graph.count_nodes(D16_FORWARD) / r,
                 "backward": graph.count_nodes(D16_BACKWARD) / r}
        expected_nodes = {
            "forward": sum(want.get(k, 0) for k in FORWARD_KERNELS),
            "backward": sum(want.get(k, 0) for k in BACKWARD_KERNELS)}
        if per != want or nodes != expected_nodes:
            raise AssertionError(
                f"{name}: launches per repeat {per} and D = 16 attention "
                f"kernel nodes {nodes}, expected {want} and "
                f"{expected_nodes}")
        t0 = time.perf_counter()
        times = cuda_times(lambda: step(*args), self.replays, self.warmup)
        t1 = time.perf_counter()
        kernels = replay_kernels(lambda: step(*args))
        t2 = time.perf_counter()
        f = self._factor()
        wall = statistics.median(times) / r * f
        spread = (max(times) - min(times)) / r * f
        device = sum(us for us, _ in kernels.values()) / 1e3 / r * f
        if device <= 0:
            device = None       # every record of the window lost
        del step, graph
        return {self.unit: wall, "spread_" + self.unit: spread,
                "device_" + self.unit: device,
                "device_kernels": sum(n for _, n in kernels.values()) / r,
                "wall_vs_device_beyond_spread": (
                    None if device is None else abs(wall - device) > spread),
                "launches": per, "attention_nodes": nodes,
                "host_s": dict(capture=t0 - start, timing=t1 - t0,
                               profile=t2 - t1)}

    def _on_host(self, repeated, args, r):
        for _ in range(self.warmup):
            repeated(*args)
        times = []
        for _ in range(max(1, self.replays)):
            t0 = time.perf_counter()
            repeated(*args)
            times.append((time.perf_counter() - t0) * 1e3)
        f = self._factor()
        return {self.unit: statistics.median(times) / r * f,
                "spread_" + self.unit: (max(times) - min(times)) / r * f,
                "device_" + self.unit: None, "launches": {}}

    def _print(self, row):
        u = self.unit
        device = row["device_" + u]
        dev = (f"{device:9.3f} {u}" if device is not None else
               "not recorded" if self.cuda else "not measured")
        print(f"{row['piece']:56s} {row[u]:9.3f} {u}/repeat (r={row['r']}, "
              f"spread {row['spread_' + u]:.3f}; device {dev}) launches "
              f"{row['launches']}", flush=True)

    def value(self, name):
        """The wall time per repeat of the row ``name``."""
        return next(r[self.unit] for r in self.rows if r["piece"] == name)

    def weighted(self, predicate):
        """Σ depth × wall time over the rows for which ``predicate(row)``
        holds."""
        return sum(r["depth"] * r[self.unit] for r in self.rows
                   if predicate(r))

    def record(self, **extra):
        """The run's JSON object; printed as the last line of stdout and
        written to ``--out``."""
        out = dict(tool=self.tool, card=self.card, device=str(self.device),
                   dtype=str(self.dtype).split(".")[-1], unit=self.unit,
                   r=self.r, replays=self.replays, warmup=self.warmup,
                   rows=self.rows, **extra)
        text = json.dumps(out)
        if self.out:
            with open(self.out, "w") as f:
                f.write(text + "\n")
        print(text, flush=True)
        return out
