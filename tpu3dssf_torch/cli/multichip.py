"""The multi-card dry run: the port of ``__graft_entry__.dryrun_multichip``.

One process per rank, one card each, over NCCL (the layout picks it:
:func:`tpu3dssf_torch.parallel.mesh.pick_backend`):

    torchrun --nproc_per_node 4 -m tpu3dssf_torch.cli.multichip [--out F]

and on the CPU, over gloo, at the tiny sizes (``--tiny``):

    torchrun --nproc_per_node 2 -m tpu3dssf_torch.cli.multichip \\
        --device cpu --tiny

The JAX dry run shrinks its sizes only to fit a CPU mesh; on the cards this
runs at full width. Three phases, each held against the one-process result
on one card, as the JAX script holds each against the unsharded one:

1. **Data parallel** (:func:`dp_phase`): the flagship pipeline as
   ``_flagship(..., small=False)`` builds it (34,816 points, 25,600
   voxels, window 1024, 384-wide tokens; bf16 on the card), one scene per
   rank. Two train steps, one eval, save → restore → a third step, then a
   ``grad_accum=2`` step at global batch 2 × ranks. Every step is one CUDA
   graph per rank with its gather and gradient all-reduce inside
   (``graph_train_step``), the eval step one graph. Rank 0 then runs the
   same sequence in one process on the global batch, and holds the second
   step's gradients and each update to it leaf by leaf (:func:`leaf_rule`:
   the same bits at one rank; at more, each leaf within
   :data:`GRAD_LEAF_TOL` and :data:`UPDATE_LEAF_TOL` of the one-process
   leaf's norm). ``--faults`` also runs two steps with each of
   :data:`FAULTS` planted in the gradient all-reduce, each of which must
   fail those rules. The graphed eval frame and train step are timed
   (CUDA-event medians of ``--reps`` calls): ms and points/s per card.
2. **Tensor parallel** (:func:`tp_phase`): ViT-L/16 (LayerScale
   :data:`TP_LAYERSCALE`, so that attention moves the tokens) at TP =
   min(4, ranks) × DP over the
   rest, 6 cameras at 640 × 1138 per data rank, K1 at 16 / TP heads a
   rank, against the unsharded encode of the same images (each rank
   computes it before it cuts its shard): max |err| and the error over
   max |unsharded| against :data:`REL_TOL`.
3. **Sequence parallel** (:func:`sp_phase`): one PTv3 block (C = 256, 16
   heads of 16, window 1024: K1 in its forward, K2/K3 with its gradient) over every
   rank at N = ranks × 8 × 1024 points, its CPE halo point to point under
   NCCL, against the unsharded block: max |err| of the output and the
   input gradient.

Rank 0 prints one JSON line per phase and the whole record as the last
line (``--out`` writes it to a file too). A failed check raises: every
phase runs, then the process exits non-zero with each phase's failure, and
torchrun with it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the flagship's full sizes: one scene a rank; ``--tiny`` for the CPU
FULL = dict(point_cap=34816, voxel_cap=25600, window=1024, tok_dim=384,
            small=False, vit="dinov3_large", sp_channels=256, sp_heads=16,
            sp_window=1024, sp_points_per_rank=8 * 1024, sp_mlp=4.0)
TINY = dict(point_cap=256, voxel_cap=64, window=16, tok_dim=16, small=True,
            vit="tiny", sp_channels=32, sp_heads=2, sp_window=16,
            sp_points_per_rank=64, sp_mlp=2.0)
# the one-process comparisons. REL_TOL: chip_smoke.py's phase 3 rule. DP:
# at one rank the mesh steps are the one-process steps, bit for bit; at
# more, every parameter's gradient (of the second step) and its update
# from the start, leaf by leaf, within these shares of the one-process
# leaf's norm (``leaf_rule``). Faults planted (``--faults``): no gradient
# all-reduce (each rank keeps its own scenes' share) and an all-reduce that
# averages where the step must sum (the gathered loss is the whole
# batch's). H100, 4 NCCL ranks, full width: sound gradient 0.014, updates
# 0.062-0.072; no all-reduce 0.78 / 0.97; averaging 0.75 / 0.26 (Adam
# ignores the gradient's scale, so the gradient rule is what sees it).
REL_TOL = 0.02
GRAD_LEAF_TOL, UPDATE_LEAF_TOL = 0.05, 0.2
FAULTS = ("no_all_reduce", "mean")
LR, WEIGHT_DECAY = 1e-3, 1e-2          # the JAX dry run's AdamW
# kernel launches per scene-batch of the full flagship train step (K2/K3
# at the C >= 128 blocks, K4/K5 at C = 32/64; LN and LNB at PTv3's 57
# LayerNorms: two a block, the embedding's, one a pooling, two an
# unpooling) and of its eval forward
PTV3_NORMS = 2 * 22 + 1 + 4 + 2 * 4
TRAIN_LAUNCHES = {"K2": 14, "K3": 14, "K4": 8, "K5": 8, "LN": PTV3_NORMS,
                  "LNB": PTV3_NORMS}
EVAL_LAUNCHES = {"K1": 22, "LN": PTV3_NORMS}
# ViT-L/16: its layers (K1 each), its LayerNorms (two a layer, the last)
VITL_LAYERS = 24
VITL_NORMS = 2 * VITL_LAYERS + 1
# the TP ViT-L's LayerScale. At DINOv3's random-init 1e-5 the blocks add
# less than a bf16 ulp to the tokens, and TP = 2 read 0.0 against the
# unsharded encode with K1 sound and 0.06% with its scale 25% high: blind.
# At 0.1 (H100, two ranks on one card over gloo): sound 1.55%, K1's plain
# version 1.80%, scale x 1.1 2.58%, x 1.25 3.09%, so REL_TOL parts a fault
# from the sound reading; at 1.0 the sound reading was 2.5%, as x 1.25's
# 3.75% was close. TP = 4 over NCCL (4 heads a rank) read 1.80 / 1.80 /
# 2.58 / 3.09% (probes/tp_layerscale.py)
TP_LAYERSCALE = 0.1


def flagship(point_cap, voxel_cap, window, batch, tok_dim=384, small=False,
             dtype=torch.float32):
    """The port of ``__graft_entry__._flagship``: (PipelineConfig, numpy
    inputs (points, valid, tokens, cam_K, lidar2cam)) from the same seeded
    numpy draws, so the JAX and the port see the same inputs."""
    from tpu3dssf_torch.models.fusion import FusionConfig, PipelineConfig
    from tpu3dssf_torch.models.ptv3 import PTv3Config

    if small:
        ptv3 = PTv3Config(
            orders=("z", "z-trans"), enc_depths=(1, 1),
            enc_channels=(16, 32), enc_heads=(2, 4),
            enc_window=(window, window), dec_depths=(1,),
            dec_channels=(64,), dec_heads=(4,), dec_window=(window,),
            use_pallas=False, dtype=dtype)
    else:
        ptv3 = PTv3Config(enc_window=(window,) * 5, dec_window=(window,) * 4,
                          dtype=dtype)
    cfg = PipelineConfig(fusion=FusionConfig(patch_tok_dim=tok_dim,
                                             dtype=dtype),
                         ptv3=ptv3, voxel_size=0.1, voxel_capacity=voxel_cap)
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(size=(batch, point_cap, 3)) * 20,
                          rng.random((batch, point_cap, 1))],
                         axis=-1).astype(np.float32)
    valid = np.ones((batch, point_cap), bool)
    tokens = (rng.normal(size=(batch, 6, 2840, tok_dim)) * 0.02).astype(
        np.float32)
    K = np.zeros((batch, 6, 3, 3), np.float32)
    K[:, :, 0, 0] = K[:, :, 1, 1] = 1266.0
    K[:, :, 0, 2], K[:, :, 1, 2], K[:, :, 2, 2] = 800.0, 450.0, 1.0
    Rt = np.tile(np.eye(4, dtype=np.float32), (batch, 6, 1, 1))
    return cfg, (pts, valid, tokens, K, Rt)


def flagship_batch(inputs, labels_seed=1):
    """The dry run's train batch of the flagship inputs: labels from
    ``default_rng(1)``, every point's label counted (mask all True)."""
    pts, valid, _, K, Rt = inputs
    n, P = valid.shape
    rng = np.random.default_rng(labels_seed)
    return {"points": pts, "point_valid": valid,
            "labels": rng.integers(0, 17, size=(n, P)).astype(np.int32),
            "mask": np.ones((n, P), bool), "cam_intrinsics": K,
            "lidar2cam": Rt}


def _to(batch, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _counts():
    from tpu3dssf_torch.kernels import modules
    return dict(modules.launch_counts())


def _launches(fn):
    """(fn's result, the kernel launches it made, zero counts left out)."""
    before = _counts()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    after = _counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def _event_ms(fn, reps, device):
    """CUDA-event ms of each of ``reps`` calls after two untimed ones
    (wall ms on the CPU)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def _gathered(mesh, obj):
    import torch.distributed as dist
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def _params(state):
    return [p.detach().clone() for p in state.model.parameters()]


def _leaves(names, tensors):
    """Each tensor flattened in f32, less the key third of each
    ``attn.qkv.bias``: its gradient is 0 in exact arithmetic (softmax
    ignores a key bias shared by every key), so both runs hold rounding
    noise there and Adam moves it by that noise (chip_smoke.
    split_key_bias)."""
    out = []
    for name, t in zip(names, tensors):
        t = t.reshape(-1).float()
        if name.endswith("attn.qkv.bias"):
            C = t.numel() // 3
            t = torch.cat([t[:C], t[2 * C:]])
        out.append(t)
    return out


def leaf_rule(names, got, want, limit, ranks):
    """Two runs' tensors, leaf by leaf (parameters, or their gradients or
    updates): at one rank the same bits in every leaf; at more, each
    leaf's ``‖got − want‖ / ‖want‖`` (key biases apart, :func:`_leaves`)
    at most ``limit``. Returns the worst leaf's reading, its name and
    ``ok``."""
    if ranks == 1:
        same = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
        bad = [n for n, ok in zip(names, same) if not ok]
        return dict(bit_equal=not bad, worst_leaf=bad[0] if bad else None,
                    ok=not bad)
    worst, leaf = 0.0, None
    for n, g, w in zip(names, _leaves(names, got), _leaves(names, want)):
        d, ref = float((g - w).norm()), float(w.norm())
        rel = d / ref if ref > 0 else (0.0 if d == 0 else math.inf)
        if rel >= worst:
            worst, leaf = rel, n
    return dict(worst_leaf_rel=worst, worst_leaf=leaf, limit=limit,
                ok=bool(worst <= limit))


def update_rule(names, start, got, want, ranks):
    """The mesh run's update of every parameter from ``start`` against the
    one-process run's (:func:`leaf_rule` at :data:`UPDATE_LEAF_TOL`)."""
    return leaf_rule(names, [g.float() - s.float() for g, s in
                             zip(got, start)],
                     [w.float() - s.float() for w, s in zip(want, start)],
                     UPDATE_LEAF_TOL, ranks)


def _grads(state):
    return [p.grad.detach().clone() for p in state.model.parameters()]


def _state(cfg, device, state_dict=None, seed=1):
    """The flagship's train state: seeded init or ``state_dict``, AdamW as
    the JAX dry run's."""
    from tpu3dssf_torch.models.fusion import SegmentationPipeline
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.train.state import TrainState, create_optimizer

    model = init_weights(SegmentationPipeline(cfg), seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(device)
    return TrainState(model, create_optimizer(
        model.parameters(), "AdamW", LR, weight_decay=WEIGHT_DECAY))


def _finite(x):
    return bool(np.isfinite(float(x)))


def _planted(fault, mesh):
    """``all_reduce_grads`` with ``fault`` planted: ``no_all_reduce`` keeps
    each rank's own share, ``mean`` divides the sum by the ranks."""
    from tpu3dssf_torch.parallel.mesh import all_reduce_grads

    def reduce(params, mesh_, axis="data"):
        params = list(params)
        if fault == "mean":
            all_reduce_grads(params, mesh_, axis)
            for p in params:
                p.grad.div_(mesh_.shape[axis])
        elif fault != "no_all_reduce":
            raise ValueError(f"no fault {fault!r}")
    return reduce


def _faulty_steps(fault, cfg, device, saved, mesh, loss_fn, batch, tokens):
    """Two graphed mesh steps from ``saved`` with ``fault`` planted in the
    gradient all-reduce: (parameters, gradients of the second step)."""
    from tpu3dssf_torch.parallel import replicate
    from tpu3dssf_torch.train import graph, loop

    state = _state(cfg, device, saved)
    replicate(state, mesh)
    real = loop.all_reduce_grads
    loop.all_reduce_grads = _planted(fault, mesh)
    try:
        step = graph.graph_train_step(loop.make_train_step(loss_fn,
                                                           mesh=mesh))
        step(state, batch, tokens)          # eager, then captured
        step(state, batch, tokens)          # a replay
    finally:
        loop.all_reduce_grads = real
    out = _params(state), _grads(state)
    del state, step
    return out


def dp_phase(mesh, sizes, reps=10, state_dict=None, check=True,
             faults=False):
    """Phase 1 (see the module docstring). ``state_dict`` replaces the
    seeded init (a test passes JAX's weights converted). ``faults``: also
    run two steps with each of :data:`FAULTS` planted and read them by the
    same rules, each of which must then fail. Returns the record; raises
    where a check fails."""
    import torch.distributed as dist
    from tpu3dssf_torch.losses import CELSLoss
    from tpu3dssf_torch.parallel import replicate, shard_batch
    from tpu3dssf_torch.train import graph
    from tpu3dssf_torch.train.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    from tpu3dssf_torch.train.loop import (MetricAccumulator,
                                           make_eval_step, make_train_step)

    device, ranks = mesh.device, mesh.shape["data"]
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg, inputs = flagship(sizes["point_cap"], sizes["voxel_cap"],
                           sizes["window"], 2 * ranks, sizes["tok_dim"],
                           sizes["small"], dtype)
    host = flagship_batch(inputs)
    tokens = torch.from_numpy(inputs[2]).to(device, dtype)
    one = {k: v[:ranks] for k, v in host.items()}      # a scene a rank
    batch1 = _to(shard_batch(one, mesh), device)
    tokens1 = shard_batch(tokens[:ranks], mesh)
    batch2 = _to(shard_batch(host, mesh, microbatches=2), device)
    tokens2 = shard_batch(tokens, mesh, microbatches=2)
    loss_fn = CELSLoss(weight=np.ones(16, np.float32))

    state = _state(cfg, device, state_dict)
    replicate(state, mesh)
    names = [n for n, _ in state.model.named_parameters()]
    start = _params(state)
    saved = {k: v.detach().cpu().clone()
             for k, v in state.model.state_dict().items()}
    step = graph.graph_train_step(make_train_step(loss_fn, mesh=mesh))
    captures = graph.CAPTURES
    record = dict(ranks=ranks, backend=mesh.backend,
                  points_per_rank=int(batch1["point_valid"].sum()))

    m1, l1 = _launches(lambda: step(state, batch1, tokens1))
    m2, l2 = _launches(lambda: step(state, batch1, tokens1))
    after2, grads2 = _params(state), _grads(state)
    record.update(loss1=float(m1["loss"]), loss2=float(m2["loss"]),
                  valid1=int(m1["valid"]), step_after_2=state.step,
                  launches_first=l1, launches_replay=l2)

    evaluate = make_eval_step(loss_fn, 16, mesh)
    acc = MetricAccumulator(16, mesh=mesh)
    with torch.inference_mode():
        (_, le) = _launches(lambda: acc.add(evaluate(state.model, batch1,
                                                     tokens1)))
    ev = acc.metrics()
    record.update(eval_loss=float(ev["loss"]), eval_acc=float(
        ev["overall_acc"]), eval_miou=float(ev["mean_iou"]),
        eval_launches=le)

    with tempfile.TemporaryDirectory(prefix=f"multichip{mesh.rank}_") as td:
        save_checkpoint(td, state.step, state,
                        extra={"best_acc": record["eval_acc"], "epoch": 0})
        _, _, at = restore_checkpoint(td, None, state)
    replicate(state, mesh)
    m3, _ = _launches(lambda: step(state, batch1, tokens1))
    after3 = _params(state)
    record.update(restored_at=at, loss3=float(m3["loss"]),
                  step_after_3=state.step)

    accum = graph.graph_train_step(make_train_step(loss_fn, grad_accum=2,
                                                   mesh=mesh))
    m4, l4 = _launches(lambda: accum(state, batch2, tokens2))
    after4 = _params(state)
    record.update(loss4=float(m4["loss"]), step_after_4=state.step,
                  accum_launches_first=l4)
    record["graphs_captured"] = graph.CAPTURES - captures
    # every rank holds the same bits after the graphed steps: the gradient
    # all-reduce ran inside each replay
    sums = _gathered(mesh, [float(p.double().sum()) for p in after4])
    record["ranks_agree"] = all(s == sums[0] for s in sums)

    # timing: the graphed eval frame and train step, medians of ``reps``
    with torch.inference_mode():
        frame = _event_ms(lambda: evaluate(state.model, batch1, tokens1),
                          reps, device)
    train = _event_ms(lambda: step(state, batch1, tokens1), reps, device)
    pts = record["points_per_rank"]
    record.update(
        frame_ms=float(np.median(frame)),
        frame_spread=max(frame) / min(frame),
        train_ms=float(np.median(train)),
        train_spread=max(train) / min(train),
        frame_points_per_s_per_card=pts / np.median(frame) * 1e3,
        train_points_per_s_per_card=pts / np.median(train) * 1e3)
    _, lr_ = _launches(lambda: step(state, batch1, tokens1))
    record["launches_per_replay"] = lr_
    planted = {f: _faulty_steps(f, cfg, device, saved, mesh, loss_fn,
                                batch1, tokens1)
               for f in (FAULTS if faults else ())}

    # rank 0: the same sequence in one process on the global batch
    if mesh.rank == 0:
        ref = _state(cfg, device, saved)
        one_step = graph.graph_train_step(make_train_step(loss_fn))
        full1 = _to(one, device)
        r1 = one_step(ref, full1, tokens[:ranks])
        one_step(ref, full1, tokens[:ranks])
        ref2, ref_grads2 = _params(ref), _grads(ref)
        one_eval = graph.graphed(make_eval_step(loss_fn, 16), "eval_step")
        acc1 = MetricAccumulator(16)
        with torch.inference_mode():
            acc1.add(one_eval(ref.model, full1, tokens[:ranks]))
        ev1 = acc1.metrics()
        one_step(ref, full1, tokens[:ranks])
        ref3 = _params(ref)
        one_accum = graph.graph_train_step(make_train_step(loss_fn,
                                                           grad_accum=2))
        one_accum(ref, _to(host, device), tokens)
        ref4 = _params(ref)
        cmp = dict(
            loss1_rel_err=abs(record["loss1"] - float(r1["loss"]))
            / abs(float(r1["loss"])),
            eval_loss_rel_err=abs(record["eval_loss"] - float(ev1["loss"]))
            / abs(float(ev1["loss"])),
            eval_acc_one_process=float(ev1["overall_acc"]),
            grad_2=leaf_rule(names, grads2, ref_grads2, GRAD_LEAF_TOL,
                             ranks),
            after_2=update_rule(names, start, after2, ref2, ranks),
            after_restore_3=update_rule(names, start, after3, ref3, ranks),
            after_accum_4=update_rule(names, start, after4, ref4, ranks),
            faults={f: dict(grad_2=leaf_rule(names, g, ref_grads2,
                                             GRAD_LEAF_TOL, ranks),
                            after_2=update_rule(names, start, a, ref2,
                                                ranks))
                    for f, (a, g) in planted.items()})
        del ref
    else:
        cmp = None
    record["one_process"] = _gathered(mesh, cmp)[0]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    if check:
        _check_dp(record)
    return record


def _check_dp(r):
    one = r["one_process"]
    train = dict(TRAIN_LAUNCHES)
    accum = {k: 2 * v for k, v in train.items()}
    bad = []
    if r["backend"] == "nccl":
        if r["launches_first"] != train or r["launches_per_replay"] != train:
            bad.append("train launches")
        if r["accum_launches_first"] != accum:
            bad.append("grad_accum launches")
        if r["eval_launches"] != EVAL_LAUNCHES:
            bad.append("eval launches")
        # train 1 + restore + accum + eval, each captured once
        if r["graphs_captured"] != 4:
            bad.append("graphs captured")
    if not all(_finite(r[k]) for k in ("loss1", "loss2", "loss3", "loss4",
                                       "eval_loss", "eval_acc")):
        bad.append("non-finite")
    if (r["step_after_2"], r["restored_at"], r["step_after_3"],
            r["step_after_4"]) != (2, 2, 3, 4):
        bad.append("step counts")
    if not r["ranks_agree"]:
        bad.append("ranks hold different parameters")
    if one["loss1_rel_err"] > REL_TOL or one["eval_loss_rel_err"] > REL_TOL:
        bad.append("loss against one process")
    for k in ("grad_2", "after_2", "after_restore_3", "after_accum_4"):
        if not one[k]["ok"]:
            bad.append(f"against one process: {k}")
    for f, rules in one["faults"].items():
        if all(rule["ok"] for rule in rules.values()):
            bad.append(f"planted fault {f} passes")
    if bad:
        raise AssertionError(f"multichip DP: {bad}: {r}")


def _vit(sizes, device):
    """The TP phase's ViT: ViT-L/16 (LayerScale TP_LAYERSCALE, folded) on
    the card, the JAX dry run's 2-layer ViT on the CPU."""
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.vit import (ViTConfig, VisionTransformer,
                                           dinov3_large, fold_layerscale)
    if sizes["vit"] == "dinov3_large":
        cfg = ViTConfig(**{**dinov3_large().__dict__,
                           "dtype": torch.bfloat16,
                           "layerscale_init": TP_LAYERSCALE})
    else:
        cfg = ViTConfig(patch_size=16, image_size=(32, 48), hidden_size=32,
                        num_layers=2, num_heads=4, num_register_tokens=4,
                        use_rope=True)
    return fold_layerscale(init_weights(VisionTransformer(cfg), 1)), cfg


def tp_phase(mesh, sizes, vit=None, images=None, check=True):
    """Phase 2: the ViT at TP = min(4, ranks) over a (data × model) mesh.
    ``vit`` (unsharded, on the CPU) and ``images`` (dp, H, W, 3) float
    replace the seeded model and images (a test passes JAX's). Returns the
    record; raises where a check fails."""
    from tpu3dssf_torch.models.vit import prepare_tp_params
    from tpu3dssf_torch.parallel import create_mesh, vit_tp_shardings

    world, device = mesh.size, mesh.device
    tp = math.gcd(world, 4)
    dp = world // tp
    vmesh = create_mesh((dp, tp), ("data", "model"), device=device.type)
    if vit is None:
        vit, cfg = _vit(sizes, device)
    cfg = vit.config
    if images is None:
        gen = torch.Generator().manual_seed(2)
        n_cam = 6 if sizes["vit"] == "dinov3_large" else 1
        images = torch.randn((dp * n_cam,) + tuple(cfg.image_size) + (3,),
                             generator=gen)
    per = images.shape[0] // dp
    r = vmesh.coords["data"]
    mine = torch.as_tensor(images)[r * per:(r + 1) * per].to(device,
                                                             cfg.dtype)
    vit = vit.to(device).eval()
    with torch.inference_mode():
        want = vit(mine)["patch_features"]
        prepare_tp_params(vit, cfg, vmesh)
        vit_tp_shardings(vit, vmesh)
        vit(mine)                                   # the kernels' first call
        got, counts = _launches(lambda: vit(mine)["patch_features"])
    err = float((got.float() - want.float()).abs().max())
    peak = float(want.float().abs().max())
    record = dict(tp=tp, dp=dp, heads_per_rank=cfg.num_heads // tp,
                  channels_per_rank=cfg.hidden_size // tp, launches=counts,
                  max_abs_err=err, rel_err=err / max(peak, 1e-30),
                  tokens=list(got.shape), backend=vmesh.backend)
    if check:
        ok = record["rel_err"] <= REL_TOL and bool(torch.isfinite(
            got.float()).all())
        if device.type == "cuda":
            ok = ok and counts == {"K1": VITL_LAYERS, "LN": VITL_NORMS}
        if not ok:
            raise AssertionError(f"multichip TP ViT: {record}")
    del vit
    return record, got


def sp_phase(mesh, sizes, block_state=None, x=None, mask=None, check=True):
    """Phase 3: one PTv3 block sequence-parallel over every rank, its output
    and input gradient against the unsharded block's. ``block_state``,
    ``x`` (B, N, C) and ``mask`` (B, N) replace the seeded ones (a test
    passes JAX's). Returns (record, this rank's output span, its input
    gradient summed over the ranks); raises where a check fails."""
    import torch.distributed as dist
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.ptv3 import PTv3Block
    from tpu3dssf_torch.parallel import create_mesh, sp_block_apply
    from tpu3dssf_torch.parallel import sp as halos

    device, world = mesh.device, mesh.size
    seq = create_mesh((world,), ("seq",), device=device.type)
    dt = torch.bfloat16 if device.type == "cuda" else torch.float32
    C, H, W = sizes["sp_channels"], sizes["sp_heads"], sizes["sp_window"]
    blocks = []
    for sp in (None, "seq"):
        blk = init_weights(PTv3Block(C, H, W, sizes["sp_mlp"], dtype=dt,
                                     sp_axis=sp), 3)
        if block_state is not None:
            blk.load_state_dict(block_state)
        blocks.append(blk.to(device))
    if x is None:
        N = world * sizes["sp_points_per_rank"]
        gen = torch.Generator().manual_seed(3)
        x = torch.randn(1, N, C, generator=gen)
        mask = torch.arange(N)[None, :] < N - 37
    x = torch.as_tensor(x).to(device, dt)
    mask = torch.as_tensor(mask).to(device)
    span = x.shape[1] // world
    lo = seq.coords["seq"] * span

    xr = x.clone().requires_grad_()
    want = blocks[0](xr, None, None, mask)
    want.float().sum().backward()
    want = want.detach()
    xs = x.clone().requires_grad_()

    def run():
        y = sp_block_apply(blocks[1], xs, mask, seq, axis="seq")
        y.float().sum().backward()
        return y

    ops0 = halos.P2P_OPS
    with torch.no_grad():
        _, fwd_counts = _launches(lambda: sp_block_apply(
            blocks[1], x, mask, seq, axis="seq"))
    ops1 = halos.P2P_OPS
    got, counts = _launches(run)
    # the CPE's one exchange a forward and one a backward: a send and a
    # receive a neighbour each, under NCCL
    index = seq.coords["seq"]
    per = 2 * ((index > 0) + (index < world - 1)) \
        if seq.backend == "nccl" else 0
    p2p = dict(forward=ops1 - ops0, forward_backward=halos.P2P_OPS - ops1,
               expected=[per, 2 * per])
    g = xs.grad.float()
    dist.all_reduce(g, group=seq.group("seq"))
    got = got.detach()
    err = float((got.float() - want[:, lo:lo + span].float()).abs().max())
    gerr = float((g - xr.grad.float()).abs().max())
    record = dict(points=x.shape[1], points_per_rank=span, channels=C,
                  heads=H, forward_launches=fwd_counts, launches=counts,
                  max_abs_err=err,
                  rel_err=err / max(float(want.float().abs().max()), 1e-30),
                  grad_max_abs_err=gerr,
                  grad_rel_err=gerr / max(float(xr.grad.float().abs().max()),
                                          1e-30),
                  halo_p2p_ops=p2p, backend=seq.backend)
    if check:
        ok = (record["rel_err"] <= REL_TOL
              and record["grad_rel_err"] <= REL_TOL
              and [p2p["forward"], p2p["forward_backward"]]
              == p2p["expected"])
        if device.type == "cuda":
            ok = (ok and fwd_counts == {"K1": 1, "LN": 2}
                  and counts == {"K2": 1, "K3": 1, "LN": 2, "LNB": 2})
        if not ok:
            raise AssertionError(f"multichip SP block: {record}")
    return record, got, g


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true",
                        help="the JAX dry run's CPU sizes")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--faults", action="store_true",
                        help="also plant the DP phase's faults")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from tpu3dssf_torch.cli.common import card_line
    from tpu3dssf_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = create_mesh(device=args.device)
    sizes = TINY if args.tiny else FULL
    lead = mesh.rank == 0
    out = dict(ranks=mesh.size, backend=mesh.backend,
               device=str(mesh.device),
               card=card_line() if mesh.device.type == "cuda" else "cpu")
    failed = []
    try:
        for name, run in (("dp", lambda: dp_phase(mesh, sizes, args.reps,
                                                  faults=args.faults)),
                          ("tp", lambda: tp_phase(mesh, sizes)[0]),
                          ("sp", lambda: sp_phase(mesh, sizes)[0])):
            t0 = time.perf_counter()
            try:
                out[name] = run()
            except AssertionError as e:
                failed.append(f"{name}: {e}")
                out[name] = {"failed": str(e)}
            out[name]["wall_s"] = time.perf_counter() - t0
            if lead:
                print(f"multichip({mesh.size}) {name}: "
                      + json.dumps(out[name]), flush=True)
    finally:
        mesh.close()
    if lead:
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        print(json.dumps(out), flush=True)
    if failed:
        raise AssertionError("multichip: " + "; ".join(failed))
    return out


if __name__ == "__main__":
    main()
