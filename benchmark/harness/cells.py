"""One run of one cell: set-up, warm-up, the measured window, the traced
window, then the check against the reference.

The program is driven through the calls its CLIs make
(``tpu3dssf_torch.cli.common``: ``load_config``, ``build_vit``,
``build_pipeline``, ``build_loss``, ``batch_to_device``, ``zero_tokens``;
``train.loop``: ``make_image_encode_fn``, ``make_eval_step``,
``MetricAccumulator``; ``train.graph``: ``graphed``), with the weights
replaced by the benchmark's seeded ones. A frame is what ``main_infer``
does for one batch: the batch and its images copied to the card, the
graphed encode, the graphed step, and its answer on the host: per-point
labels (loop ``stream``, closed, one client) or the batch's loss and
counts folded into the accumulator (loop ``eval``, as ``main_test``
streams a split; the window ends when the accumulator's sums reach the
host).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import check, counts, spec
from benchmark.harness import trace as tracing
from benchmark.harness import weights as W
from benchmark.harness.check import log
from benchmark.traffic import generator

WARMUP_FRAMES = 3
LOG_EVERY = 10       # train_model reads its window sums every 10 steps


@torch.inference_mode()
def _labels(model, batch, tokens):
    """The argmax label of every point: what a user replaying a drive
    takes home."""
    return model(batch["points"], batch["point_valid"], tokens,
                 batch["cam_intrinsics"], batch["lidar2cam"]).argmax(-1).to(
                     torch.uint8)


def seeded_weights(cfg, seed, device):
    """(pipeline weights, ViT weights or None): the reference's parameter
    layout at the configuration's widths, drawn on ``device``."""
    from benchmark.reference import widths
    from benchmark.reference.models import Segmentation
    from benchmark.reference.vit import ViT
    table = widths.of(cfg)
    with torch.device("meta"):
        seg = Segmentation(table, cfg.voxel_size, 1024, "mean", "own")
        vit = ViT(table.vit) if table.fusion else None
    return (W.make_weights(seg, 2 * seed + 1, device),
            None if vit is None else W.make_weights(vit, 2 * seed + 2,
                                                    device))


class Program:
    """The program's objects of one cell, built as its CLIs build them."""

    def __init__(self, cfg, traffic, w_pipe, w_vit, device):
        from tpu3dssf_torch.cli import common
        from tpu3dssf_torch.train.graph import graph_train_step, graphed
        from tpu3dssf_torch.train.loop import (MetricAccumulator,
                                               make_eval_step,
                                               make_image_encode_fn,
                                               make_train_step)
        loop = traffic["loop"]
        self.common, self.cfg, self.loop = common, cfg, loop
        self.device = device
        t0 = time.perf_counter()
        self.encode, vit_cfg = None, None
        if cfg.image_encoder != "none":
            vit, vit_cfg = common.build_vit(cfg, device)
            W.load(vit, _folded(vit, w_vit))
            self.encode = graphed(make_image_encode_fn(
                vit, vit_cfg.image_size, vit_cfg.dtype), "encode")
        self.model, _ = common.build_pipeline(cfg, vit_cfg, device)
        W.load(self.model, w_pipe)
        log(f"models built in {time.perf_counter() - t0:.3f} s")
        if loop == "stream":
            self.step = graphed(_labels, "infer_labels")
        elif loop == "eval":
            self.step = graphed(make_eval_step(common.build_loss(cfg),
                                               cfg.mlp_class), "eval_step")
            self.acc = MetricAccumulator(cfg.mlp_class)
        elif loop == "train":
            self.state = common.init_state(cfg, self.model,
                                           traffic["steps_per_epoch"])
            self.step = graph_train_step(make_train_step(
                common.build_loss(cfg), None, cfg.tpu.grad_accum))
            self.win, self.steps = None, 0
        else:
            raise ValueError(f"unknown loop {loop!r}")

    def frame(self, host, span):
        """One batch from the pool to its answer on the host (labels) or
        in the accumulator (eval); returns that answer."""
        common = self.common
        images = host.get("images")
        inputs = {k: v for k, v in host.items() if k != "images"}
        with span("h2d"):
            batch = common.batch_to_device(inputs, self.device)
            if images is not None:
                images = torch.as_tensor(images).to(self.device)
        if self.encode is not None:
            with span("encode"):
                tokens = self.encode(images)
        else:
            tokens = common.zero_tokens(self.cfg, None,
                                        batch["points"].shape[0], self.device)
        if self.loop == "train":
            with span("step"):
                m = self.step(self.state, batch, tokens)
            return self._fold(m)
        with span("forward"):
            out = self.step(self.model, batch, tokens)
        if self.loop == "stream":
            with span("to_host"):
                return out.cpu().numpy()
        self.acc.add(out)
        return out

    def _fold(self, m):
        """A step's metrics into the window sums, read on the host every
        :data:`LOG_EVERY` steps, as ``train_model`` does."""
        m = {"loss": m["loss"].to(torch.float32, copy=True),
             "correct": m["correct"].to(torch.int64, copy=True),
             "valid": m["valid"].to(torch.int64, copy=True)}
        self.win = m if self.win is None else {k: self.win[k] + m[k]
                                               for k in m}
        self.steps += 1
        if self.steps % LOG_EVERY == 0:
            self.host_sums = {k: float(v) for k, v in self.win.items()}
        return m

    def close_window(self):
        """The end of the window: the eval or train sums on the host."""
        if self.loop == "eval":
            self.acc.metrics()
        if self.loop == "train" and self.win is not None:
            self.host_sums = {k: float(v) for k, v in self.win.items()}
        _sync(self.device)

    def first_gradient(self):
        """Each parameter's gradient as the optimizer took it in its first
        update, from AdamW's first moment: m₁ = (1 − β₁)·g₁."""
        inner = self.state.optimizer.inner
        b1 = inner.param_groups[0]["betas"][0]
        return {n: (inner.state[p]["exp_avg"] / (1.0 - b1)
                    if "exp_avg" in inner.state[p] else torch.zeros_like(p))
                for n, p in self.model.named_parameters()}

    def parameters(self):
        return {n: p.detach().clone()
                for n, p in self.model.named_parameters()}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _folded(vit, w_vit):
    """The ViT weights for the program's ViT, whose LayerScale is folded
    into its dense layers: the benchmark's gammas are 1, so folding leaves
    every other weight as drawn."""
    names = {n for n, _ in vit.named_parameters()}
    for n, v in w_vit.items():
        if n not in names and not (n.rsplit(".", 2)[-2] in ("ls1", "ls2")
                                   and bool((v == 1).all())):
            raise KeyError(f"the program's ViT has no parameter {n}")
    return {n: v for n, v in w_vit.items() if n in names}


class Spans:
    """CUDA events around each stage of every frame, and a profiler range
    ``bench::<stage>`` around it (trace runs only)."""

    def __init__(self, on: bool):
        self.on = on
        self.events: Dict[str, List] = {}

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function("bench::" + name):
            start.record()
            yield
            end.record()
        self.events.setdefault(name, []).append((start, end))

    def ms(self):
        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self.events.items()}


@dataclasses.dataclass
class Record:
    """What the per-layer readers read: ``kind`` (the traffic's loop:
    "stream", "eval" or "train"), the spans' milliseconds by stage over the
    window's frames, the traced window and the counted work of its
    frames."""

    kind: str
    spans: Dict[str, List[float]]
    trace: tracing.Trace
    work: counts.Work


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False):
    """One run of ``cell``; returns (result dict, the compared numbers,
    the control's numbers where ``control``)."""
    from tpu3dssf_torch.cli import common

    cfg = common.load_config(cell.config_path)
    traffic = cell.traffic
    loop = traffic["loop"]
    fusion = cfg.image_encoder != "none"
    pool = generator.make_pool(traffic, seed, cfg.tpu.point_capacity,
                               device, cameras=fusion)
    points = [int(b["point_valid"].sum()) for b in pool]
    w_pipe, w_vit = seeded_weights(cfg, seed, device)
    log(f"pool and weights made at {time.perf_counter() - t_start:.3f} s")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    program = Program(cfg, traffic, w_pipe, w_vit, device)
    log(f"program built at {time.perf_counter() - t_start:.3f} s")
    order = generator.visit_order(seed, len(pool))
    off = Spans(False)
    first, g1 = [], None
    for k in range(WARMUP_FRAMES):
        i = next(order)
        first.append((i, program.frame(pool[i], off)))
        if loop == "train" and k == 0:
            g1 = program.first_gradient()
    p3 = program.parameters() if loop == "train" else None
    program.close_window()
    if loop == "eval":
        program.acc = type(program.acc)(cfg.mlp_class)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    spans = Spans(trace)
    frames, latencies, starts, done_points = [], [], [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = next(order)
        ts = time.perf_counter()
        frames.append((i, program.frame(pool[i], spans)))
        latencies.append((time.perf_counter() - ts) * 1e3)
        starts.append(ts - t0)
        done_points += points[i]
    program.close_window()
    window_s = time.perf_counter() - t0
    log(f"window {window_s:.3f} s, {len(frames)} frames, "
        f"{done_points} valid points; frames begun a second "
        f"{np.bincount(np.asarray(starts, int)).tolist()}; latency ms "
        f"quartiles {np.percentile(latencies, [25, 50, 75]).round(3)}")

    metrics = {}
    if trace:
        traced, ranges = [], Spans(True)   # the traced frames' own spans

        def traced_frame():
            i = next(order)
            traced.append(i)
            program.frame(pool[i], ranges)

        t = tracing.record(traced_frame, traffic["trace_frames"])
        traced = traced[1:]          # the first was the profiler's warm-up
        work = counts.Work()
        for i in traced:
            work = work + counts.batch_work(pool[i], cfg,
                                            train=loop == "train")
        rec = Record(loop, spans.ms(), t, work)
        log(f"traced {t.frames} frames in {t.window_s:.4f} s, device busy "
            f"{t.busy_s:.4f} s; attention exp term {work.attn_exp_s:.6f} s "
            f"against the bound {work.attn_s:.6f} s")
        for m in cell.per_layer:
            value = spec.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rate = done_points / window_s
        e2e = {"infer_points_per_s": rate if loop != "train" else None,
               "train_points_per_s": rate if loop == "train" else None,
               "infer_latency_p95_ms": (float(np.percentile(latencies, 95))
                                        if loop == "stream" else None),
               "setup_s": setup_s}
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    if loop == "train":
        chosen = check.TrainRun([float(m["loss"]) for _, m in first], g1,
                                p3, [i for i, _ in first])
    else:
        chosen = check.sample(seed, frames, traffic["check_frames"])
    del program, frames, first
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = check.Reference(cfg, w_pipe, w_vit, device,
                          traffic.get("steps_per_epoch", 1))
    found = check.numbers(loop, ref, pool, chosen)
    ctrl = check.control_numbers(loop, ref, pool, chosen) if control \
        else None
    result = {
        "correct": all(found[k] <= cell.limits[k] for k in found),
        "attempted": len(latencies),
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = t.breakdown()
    result["checks"] = {k: {"value": v, "limit": cell.limits[k]}
                        for k, v in found.items()}
    return result, found, ctrl
