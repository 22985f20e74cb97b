"""One run of a benchmark cell with the program's spans on: the spans'
sums by stage, the idle gaps named by the program's ranges, and the nodes
of the cell's CUDA graphs.

    python3 probes/span_cells.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1> --spans <0|1> [--nodes 0|1] \
        [--root DIR] [--out FILE]

Runs ``benchmark/harness/cells.run`` of the checkout at ``--root`` (this
one by default) as ``benchmark/run.py`` does, with
``tpu3dssf_torch.utils.timing.enable_spans`` called first where
``--spans 1``. The spans are reset when the warm-up ends and summed when
the measured window ends (``Program.close_window``). With ``--trace 1``
the profiler window's events are also reduced here (:func:`split_idle`):
each idle gap between busy intervals is named ``replay:<graph>`` where both
sides are device operations of one ``cudaGraphLaunch`` (the graph named by
the ``tpu3dssf::replay:<graph>`` range open at that launch), else by the
innermost ``tpu3dssf::`` range open at the gap's middle, else by the
benchmark's ``bench::`` range, else ``other``; ``graph_gap_s`` sums the
first kind. :func:`stage_metrics` turns the sums into the per-layer
numbers a traced run would report (per frame or step of the window).
``--nodes 1`` captures the cell's graphs with ``nodes=True`` and prints
per graph the count of each node kind and a digest of the kernel nodes'
labels with every number taken out, so two checkouts' graphs compare.

The probe patches the harness from outside (``Program.close_window``,
``trace.record``, ``GraphedStep.__init__`` for ``--nodes``) because the
harness has no hook for spans yet: :func:`split_idle` and
:func:`stage_metrics` are the code that ``benchmark/harness/trace.py``
and ``readers.py`` are to take in, and the probe goes then.

Prints the run's result line (as ``benchmark/run.py`` prints it) and one
JSON line ``{"spans", "counters", "split", "stages", ...}``; ``--out``
appends that line to a file. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import re
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STAGES = {            # per-layer metric → the spans it sums
    "vit_preprocess_ms": ("vit.preprocess",),
    "voxelize_ms": ("voxelize",),
    "ptv3_blocks_ms": ("ptv3.blocks",),
    "ptv3_resample_ms": ("ptv3.serialize", "ptv3.pool", "ptv3.unpool"),
    "head_ms": ("head", "devoxelize"),
    "loss_ms": ("loss",),
    "backward_ms": ("backward",),
    "optimizer_ms": ("optimizer",),
}
ROOTS = {"stream": (("encode",), "vit_encode_ms", ("forward",),
                    "pipeline_fwd_ms"),
         "eval": (None, None, ("forward", "loss"), "pipeline_fwd_ms"),
         "train": (("encode",), "vit_encode_ms", ("update",),
                   "train_step_ms")}
FORWARD_CHILDREN = ("voxelize", "ptv3", "head", "devoxelize")


def rows(events):
    """The profiler's raw (kineto) events as plain tuples: device
    operations ``(start, end, linked correlation id, correlation id)`` and
    host events ``(start, end, name, correlation id, linked correlation
    id)``, microseconds from the first event. (The profiler's
    ``FunctionEvent`` carries no linked correlation id on every torch
    version; its kineto events do. Their clock is in integer ns since the
    epoch: taken to µs whole, a float keeps only quarter microseconds, the
    size of a gap between two graph nodes.)"""
    events = list(events)
    t0 = min((e.start_ns() for e in events), default=0)
    device, host = [], []
    for e in events:
        start = (e.start_ns() - t0) / 1e3
        end = start + e.duration_ns() / 1e3
        if e.device_type().name == "CUDA":
            if not e.is_user_annotation():
                device.append((start, end, e.linked_correlation_id(),
                               e.correlation_id()))
        else:
            host.append((start, end, e.name(), e.correlation_id(),
                         e.linked_correlation_id()))
    return device, host


def _innermost(ranges, t):
    """The name of the shortest range open at ``t``, or None."""
    best = None
    for s, e, n in ranges:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return None if best is None else best[2]


def split_idle(device, host):
    """``{"busy_s", "gaps": {name: s}, "graph_gap_s", "launch_s"}`` from
    :func:`rows`: the idle gaps between the merged busy intervals of the
    device operations, each named as the module docstring says, and the
    host's seconds inside ``cudaGraphLaunch`` by replay."""
    prog = [(s, e, n[len("tpu3dssf::"):]) for s, e, n, _, _ in host
            if n.startswith("tpu3dssf::")]
    bench = [(s, e, n[len("bench::"):]) for s, e, n, _, _ in host
             if n.startswith("bench::")]
    replays = [(s, e, n) for s, e, n in prog if n.startswith("replay:")]
    launch = {}          # ("link" | "id", value) → the replay's name
    launch_s = {}        # the replay's name → host seconds in the call
    for s, e, n, cid, link in host:
        if "cudaGraphLaunch" in n:    # spans off: named by bench's range
            name = (_innermost(replays, s)
                    or "replay:" + (_innermost(bench, s) or "?"))
            launch_s[name] = launch_s.get(name, 0.0) + (e - s) * 1e-6
            if link:
                launch[("link", link)] = name
            if cid:
                launch[("id", cid)] = name
    busy = []            # [start, end, first op, last op]
    for op in sorted(device):
        if busy and op[0] <= busy[-1][1]:
            if op[1] >= busy[-1][1]:
                busy[-1][1], busy[-1][3] = op[1], op
        else:
            busy.append([op[0], op[1], op, op])
    gaps, graph_gap = {}, 0.0
    for a, b in zip(busy, busy[1:]):
        left, right = a[3], b[2]        # the ops on either side
        name = None
        if left[2] and left[2] == right[2]:
            name = launch.get(("link", left[2]))
        if name is None and left[3] and left[3] == right[3]:
            name = launch.get(("id", left[3]))
        seconds = (b[0] - a[1]) * 1e-6
        if name is not None:
            graph_gap += seconds
        else:
            mid = 0.5 * (a[1] + b[0])
            name = (_innermost(prog, mid) or _innermost(bench, mid)
                    or "other")
        gaps[name] = gaps.get(name, 0.0) + seconds
    return {"busy_s": sum(e - s for s, e, _, _ in busy) * 1e-6,
            "gaps": gaps, "graph_gap_s": graph_gap, "launch_s": launch_s}


def stage_metrics(kind, spans, frames, bench_metrics, split=None,
                  window_s=None):
    """The new per-layer numbers of one cell (``kind``: the loop) from the
    spans' sums over ``frames`` window frames, with the root spans over
    the benchmark's own spans of the same run and the forward's named
    children over the forward."""
    def ms(*names):
        got = [spans[n]["ms"] for n in names if n in spans]
        return sum(got) / frames if got else None

    out = {}
    for metric, names in STAGES.items():
        value = ms(*names)
        if value is not None:
            out[f"{metric}.{kind}"] = value
    enqueue = [n for n in spans if n.startswith("replay:")]
    if enqueue:
        out[f"replay_enqueue_ms.{kind}"] = ms(*enqueue)
    if split is not None:
        out[f"graph_gap_pct.{kind}"] = (100.0 * split["graph_gap_s"]
                                        / window_s)
    enc, enc_bench, root, root_bench = ROOTS[kind]
    for names, bench in ((enc, enc_bench), (root, root_bench)):
        key = f"{bench}.{kind}"
        if names and key in bench_metrics and ms(*names) is not None:
            out[f"ratio.{'+'.join(names)}"] = (
                ms(*names) / bench_metrics[key]["value"])
    if ms("forward"):
        out["forward_children_share"] = (ms(*FORWARD_CHILDREN)
                                         / ms("forward"))
    return out


def _node_digest(graph):
    """Node kinds and a digest of the kernel labels without numbers and
    without runs of six or more hex digits (the per-file hashes in the
    mangled names of anonymous namespaces, which follow the build
    directory)."""
    kinds, kernels = {}, []
    for body in graph.nodes:
        if "shape=" not in body:               # an edge
            continue
        m = re.search(r"[A-Z][A-Z_]{3,}", body)
        kind = m.group(0) if m else "?"
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "KERNEL":
            kernels.append(re.sub(r"0x[0-9a-fA-F]+|[0-9a-f]{6,}|\d+", "",
                                  body))
    digest = hashlib.sha256("\n".join(sorted(kernels)).encode()).hexdigest()
    return {"kinds": kinds, "kernel_labels_sha256": digest[:16]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--nodes", type=int, choices=(0, 1), default=0)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cache = os.path.join(root, "build", "benchmark_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")

    import torch
    if not torch.cuda.is_available():
        sys.exit("span_cells.py: no CUDA device is available")
    from benchmark.harness import cells, spec
    from benchmark.harness import trace as tracing
    from tpu3dssf_torch.train import graph as graph_mod

    timing = None
    if args.spans:
        from tpu3dssf_torch.utils import timing
        timing.enable_spans(True)
    init = graph_mod.GraphedStep.__init__
    if args.nodes:
        if "nodes" not in inspect.signature(init).parameters:
            sys.exit("span_cells.py: GraphedStep takes no `nodes` argument")

        def keeping_nodes(step, *a, **kw):
            bound = inspect.signature(init).bind(step, *a, **kw)
            bound.arguments["nodes"] = True
            init(*bound.args, **bound.kwargs)

        graph_mod.GraphedStep.__init__ = keeping_nodes

    got = {"workload": args.workload, "seed": args.seed,
           "spans_on": bool(args.spans), "root": root}
    closes = []
    close_window = cells.Program.close_window

    def closing(program):
        close_window(program)
        closes.append(program)
        if timing is not None and len(closes) == 1:
            timing.reset_spans()          # the warm-up ends
        if len(closes) == 2:              # the measured window ends
            if timing is not None:
                got["spans"] = timing.span_summary()
                got["counters"] = timing.span_counters()
            if args.nodes:
                got["graphs"] = {
                    f"{s.name}:{i}": _node_digest(g)
                    for s in (program.encode, program.step) if s is not None
                    for i, g in enumerate(s.graphs.values())}

    cells.Program.close_window = closing
    record = tracing.record

    def recording(frame, frames):
        from torch.profiler import ProfilerActivity, profile, schedule
        sched = schedule(wait=0, warmup=1, active=1, repeat=1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
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
        t = tracing.reduce(prof.events(), frames, window_s)
        got["split"] = split_idle(*rows(
            prof.profiler.kineto_results.events()))
        got["bench_gaps"] = t.gaps
        got["trace_window_s"] = window_s
        got["trace_frames"] = frames
        return t

    tracing.record = recording
    cell = spec.Cell(args.workload, spec.benchmark(
        os.path.join(root, "BENCHMARK.json")))
    try:
        result, _, _ = cells.run(cell, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda", 0),
                                 T_START)
    finally:
        cells.Program.close_window = close_window
        tracing.record = record
        graph_mod.GraphedStep.__init__ = init
    print(json.dumps(result), flush=True)
    kind = cell.traffic["loop"]
    if "spans" in got:
        got["stages"] = stage_metrics(
            kind, got["spans"], result["attempted"], result["metrics"],
            got.get("split"), got.get("trace_window_s"))
    got["result"] = result
    line = json.dumps(got)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
