"""Train-step throughput on one card at nuScenes scale: the port of
``scripts/bench_train.py``.

    python -m tpu3dssf_torch.cli.bench_train               # B=2 + phase split
    python -m tpu3dssf_torch.cli.bench_train --batches 2,4,8,12 \\
        [--remat none|block|attn] [--accum N] [--phases]

Without ``--batches`` (the script's ``main``): the graphed train step
(forward, CE + Lovász at unit class weights, backward, AdamW(1e-3) with
``optax.adamw``'s weight decay 1e-4) at B = 2, 34,816 points, 25,600 voxels
and window 1024 for three rows: ``lidar-only`` (``LidarSegmentationModel``),
``lidar-only+remat`` (PTv3's per-block ``remat``) and ``fusion``
(``SegmentationPipeline`` on seeded tokens (B, 6, 2840, 384) · 0.02), each
in ms/step and points/s; the lidar-only row is then split into forward,
backward and optimizer + the rest, each part timed as a graph of its own.

``--batches`` (``TRAIN_BATCHES``, the script's ``batch_scaling``): the
fusion step at each batch size, with ``--remat`` (``TRAIN_REMAT``: per-block
``remat``, or ``remat_attention``), ``--accum`` (``TRAIN_ACCUM``: that many
sequential microbatches per update, the port's ``grad_accum``) and
``--phases`` (``TRAIN_PHASES``), each in ms, points/s and peak allocated
MiB. A batch size that fails (out of memory) prints its ``FAILED`` row and
the sweep goes on, as the script does. Not ported: ``TRAIN_MEM`` and
``TRAIN_SQUEEZE`` (``program_peak_mb``, ``hbm_squeeze``: TPU runtime
workarounds; the card reports its peak directly).

Every step is a CUDA graph replay (:mod:`tpu3dssf_torch.train.graph`),
timed as the CUDA-event median of 10 replays after warm-up; each
row also records the kernel launches of one replay. Weights are seeded
random; ``--device cpu`` runs the plain versions (tiny sizes only, through
the functions below).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

B, P, V, W = 2, 34816, 25600, 1024
TOKENS = (6, 2840, 384)   # DINOv3 ViT-S/16 patch tokens of six cameras
REMAT = {"none": {}, "block": {"remat": True},
         "attn": {"remat_attention": True}}


def train_batch(rng, batch, points, device):
    """The script's synthetic batch (points N(0, 20²) with a uniform
    intensity, labels in [0, 16], every point valid and counted, zero
    intrinsics, identity extrinsics), drawn from ``rng``."""
    host = {
        "points": np.concatenate([rng.normal(size=(batch, points, 3)) * 20,
                                  rng.random((batch, points, 1))], -1),
        "point_valid": np.ones((batch, points), bool),
        "labels": rng.integers(0, 17, (batch, points)),
        "mask": np.ones((batch, points), bool),
        "cam_intrinsics": np.zeros((batch, 6, 3, 3)),
        "lidar2cam": np.tile(np.eye(4), (batch, 6, 1, 1)),
    }
    dtypes = {"points": torch.float32, "labels": torch.int32,
              "cam_intrinsics": torch.float32, "lidar2cam": torch.float32}
    return {k: torch.as_tensor(v, dtype=dtypes.get(k)).to(device)
            for k, v in host.items()}


def row_config(tok_dim, dtype, voxel_capacity=V, ptv3_cfg=None,
               **ptv3_flags):
    """The script's ``PipelineConfig``: the fusion head at ``tok_dim``
    (at least 8), PTv3 at window W in every stage (or ``ptv3_cfg``) with
    ``ptv3_flags`` (``remat``, ``remat_attention``), voxel size 0.1."""
    from tpu3dssf_torch.models.fusion import FusionConfig, PipelineConfig
    from tpu3dssf_torch.models.ptv3 import PTv3Config

    if ptv3_cfg is None:
        ptv3_cfg = PTv3Config(enc_window=(W,) * 5, dec_window=(W,) * 4)
    ptv3_cfg = dataclasses.replace(ptv3_cfg, dtype=dtype, **ptv3_flags)
    return PipelineConfig(
        fusion=FusionConfig(point_feat_dim=ptv3_cfg.out_channels,
                            patch_tok_dim=max(tok_dim, 8), dtype=dtype),
        ptv3=ptv3_cfg, voxel_size=0.1, voxel_capacity=voxel_capacity)


def train_state(model):
    """``create_train_state(model, params, optax.adamw(1e-3))``."""
    from tpu3dssf_torch.train.state import TrainState, create_optimizer
    return TrainState(model, create_optimizer(
        model.parameters(), "AdamW", 1e-3, weight_decay=1e-4))


def loss_fn():
    from tpu3dssf_torch.losses import CELSLoss
    return CELSLoss(weight=np.ones(16, np.float32))


def replay_launches(fn):
    """The kernel launches of one call of ``fn`` (counted by the kernels'
    wrappers and by the graphs' replays), kernels with none left out."""
    from tpu3dssf_torch.kernels.modules import launch_counts
    before = launch_counts()
    fn()
    return {k: n - before[k] for k, n in launch_counts().items()
            if n != before[k]}


WARMUP, REPS = 2, 10   # replays before and in a timed median


def time_graph(fn, device, reps):
    """A graphed ``fn``: its first call (eager, then the capture), one
    replay whose kernel launches are counted, then the median of ``reps``
    replays after ``WARMUP``. Returns {ms, first_call_s, launches (of one
    replay), calls (of ``fn`` in all)}."""
    from tpu3dssf_torch.cli.bench import wall_ms
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = replay_launches(fn)
    return dict(ms=wall_ms(fn, device, reps, WARMUP), first_call_s=first,
                launches=launches, calls=2 + WARMUP + reps)


def train_row(model, batch, tokens, reps, grad_accum=1):
    """The graphed train step of ``model`` on one batch: its ms, points/s,
    first call's seconds and launches per replay; returns (row, state)."""
    from tpu3dssf_torch.train.graph import graph_train_step
    from tpu3dssf_torch.train.loop import make_train_step

    state = train_state(model)
    step = graph_train_step(make_train_step(loss_fn(), grad_accum=grad_accum))
    row = time_graph(lambda: step(state, batch, tokens),
                     batch["points"].device, reps)
    n = batch["points"].shape[0] * batch["points"].shape[1]
    row["points_per_s"] = n / (row["ms"] / 1e3)
    return row, state


def phase_split(state, batch, tokens, step_ms, reps):
    """Forward (with the loss, no gradient), forward + backward, each as a
    graph of its own: fwd ms, bwd ms and opt+misc ms by difference with
    the whole step's ``step_ms``, and each graph's :func:`time_graph`
    record (``fwd``, ``fwd_bwd``)."""
    from tpu3dssf_torch.train.graph import graphed

    model, loss = state.model, loss_fn()

    def total(points):
        logits = model(points, batch["point_valid"], tokens,
                       batch["cam_intrinsics"], batch["lidar2cam"])
        return loss(logits, batch["labels"], batch["mask"]).total

    @torch.no_grad()
    def fwd_only(points):
        return total(points)

    def fwd_bwd(points):
        state.optimizer.zero_grad()
        out = total(points)
        out.backward()
        return out.detach()

    device = batch["points"].device
    fwd = time_graph(lambda g=graphed(fwd_only, "fwd_only"):
                     g(batch["points"]), device, reps)
    both = time_graph(lambda g=graphed(fwd_bwd, "fwd_bwd"):
                      g(batch["points"]), device, reps)
    state.optimizer.zero_grad()
    return dict(fwd_ms=fwd["ms"], bwd_ms=both["ms"] - fwd["ms"],
                opt_misc_ms=step_ms - both["ms"], fwd=fwd, fwd_bwd=both)


def main_rows(device, dtype, batch_size=B, points=P, voxel_capacity=V,
              tokens_shape=TOKENS, ptv3_cfg=None, reps=REPS):
    """The script's ``main``: the three rows (and the lidar-only row's
    split) at the given sizes; prints each as the script does and returns
    {row name: row dict}."""
    from tpu3dssf_torch.models.fusion import SegmentationPipeline
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.lidar_only import LidarSegmentationModel

    rng = np.random.default_rng(0)
    batch = train_batch(rng, batch_size, points, device)
    rows = {}
    for name, tok_dim, remat in (("lidar-only", 1, False),
                                 ("lidar-only+remat", 1, True),
                                 ("fusion", tokens_shape[-1], False)):
        cfg = row_config(tok_dim, dtype, voxel_capacity, ptv3_cfg,
                         remat=remat)
        if name.startswith("lidar-only"):
            model = LidarSegmentationModel(cfg)
            tokens = torch.zeros((batch_size, 1, 1, 1), device=device)
        else:
            model = SegmentationPipeline(cfg)
            tokens = torch.as_tensor(
                rng.normal(size=(batch_size,) + tuple(tokens_shape)) * 0.02,
                dtype=dtype).to(device)
        model = init_weights(model, 0).to(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        row, state = train_row(model, batch, tokens, reps)
        row["peak_mib"] = _peak(device)
        print(f"{name:20s} train step (B={batch_size}, {points} pts): "
              f"{row['ms']:7.1f} ms ({row['points_per_s']:,.0f} points/s)"
              f"  [first call {row['first_call_s']:.0f}s] launches "
              f"{row['launches']}", flush=True)
        if name == "lidar-only":
            row.update(phase_split(state, batch, tokens, row["ms"], reps))
            print(f"{'':20s}   fwd {row['fwd_ms']:6.1f} ms | bwd "
                  f"{row['bwd_ms']:6.1f} ms | opt+misc "
                  f"{row['opt_misc_ms']:6.1f} ms (residuals of "
                  f"{row['ms']:.1f})", flush=True)
        rows[name] = row
        del model, state
        _free(device)
    return rows


def batch_scaling(batches, device, dtype, remat="none", accum=1,
                  phases=False, points=P, voxel_capacity=V,
                  tokens_shape=TOKENS, ptv3_cfg=None, reps=REPS):
    """The script's ``batch_scaling``: the fusion train step at each batch
    size, ms/step, points/s and peak allocated MiB; a failure prints its
    ``FAILED`` row and the sweep goes on. Returns {batch: row}."""
    from tpu3dssf_torch.models.fusion import SegmentationPipeline
    from tpu3dssf_torch.models.layers import init_weights

    rng = np.random.default_rng(0)
    rows = {}
    for b in batches:
        batch = train_batch(rng, b, points, device)
        tokens = torch.as_tensor(
            rng.normal(size=(b,) + tuple(tokens_shape)) * 0.02,
            dtype=dtype).to(device)
        tag = (f"{', remat=' + remat if remat != 'none' else ''}"
               f"{f', accum={accum}' if accum > 1 else ''}")
        try:
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            cfg = row_config(tokens_shape[-1], dtype, voxel_capacity,
                             ptv3_cfg, **REMAT[remat])
            model = init_weights(SegmentationPipeline(cfg), 0).to(device)
            row, state = train_row(model, batch, tokens, reps, accum)
            row["peak_mib"] = _peak(device)
            print(f"fusion train B={b:2d} ({points} pts/sample{tag}): "
                  f"{row['ms']:7.1f} ms ({row['points_per_s']:,.0f} "
                  f"points/s, {row['points_per_s'] / b:,.0f} "
                  f"pts/s/sample-slot) peak_hbm={row['peak_mib']:,.0f} MiB "
                  f"[first call {row['first_call_s']:.0f}s] launches "
                  f"{row['launches']}", flush=True)
            if phases:
                row.update(phase_split(state, batch, tokens, row["ms"], reps))
                print(f"    fwd {row['fwd_ms']:6.1f} ms | bwd "
                      f"{row['bwd_ms']:6.1f} ms | opt+misc "
                      f"{row['opt_misc_ms']:6.1f} ms", flush=True)
        except Exception as e:  # out of memory etc.: report and go on
            row = dict(failed=f"{type(e).__name__}: {str(e)[:300]}")
            print(f"fusion train B={b:2d}{tag}: FAILED {row['failed']}",
                  flush=True)
        rows[b] = row
        model = state = None
        _free(device)
    return rows


def _peak(device):
    from tpu3dssf_torch.utils import peak_hbm_mb
    return peak_hbm_mb(device)


def _free(device):
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None):
    from tpu3dssf_torch.cli.common import card_line, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", help="comma-separated batch sizes "
                    "(TRAIN_BATCHES): the fusion step at each")
    ap.add_argument("--remat", choices=tuple(REMAT), default="none",
                    help="with --batches: PTv3 remat (TRAIN_REMAT)")
    ap.add_argument("--accum", type=int, default=1,
                    help="with --batches: microbatches per update "
                         "(TRAIN_ACCUM)")
    ap.add_argument("--phases", action="store_true",
                    help="with --batches: fwd/bwd split per batch "
                         "(TRAIN_PHASES)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(card_line())
    print(f"device: {device}, dtype {str(dtype).split('.')[-1]}", flush=True)
    if args.batches:
        return batch_scaling([int(b) for b in args.batches.split(",")],
                             device, dtype, args.remat, args.accum,
                             args.phases)
    return main_rows(device, dtype)


if __name__ == "__main__":
    main()
