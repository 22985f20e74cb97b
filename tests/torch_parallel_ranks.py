"""One rank of tests/test_torch_parallel.py: the port's parallel paths on the
CPU over gloo, in a process that imports neither JAX nor ``tpu3dssf``.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \
        python -m tests.torch_parallel_ranks <dir>

reads ``<dir>/inputs.pt`` (seeded inputs and weights converted from the
JAX models, written by the test) and writes ``<dir>/rank<r>.pt``: every
result the test compares, as numpy arrays. The ranks run each case in the
same order, since every collective needs both.
"""

import contextlib
import io
import os
import sys

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy()


def _batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _lidar_model(inp):
    from tpu3dssf_torch.models.lidar_only import LidarSegmentationModel
    model = LidarSegmentationModel(inp["lidar_cfg"])
    model.load_state_dict(inp["lidar_state"])
    return model


def run_mesh(inp, out):
    from tpu3dssf_torch.parallel import create_mesh
    mesh = create_mesh((2,), ("data",), device="cpu")
    out["coords"] = mesh.coords["data"]
    out["owns_group"] = mesh.owns_group
    out["backend"], out["repr"] = mesh.backend, repr(mesh)
    try:
        create_mesh((2,), ("data",), device="cpu", backend="nccl")
    except ValueError as e:
        out["backend_error"] = str(e)
    try:
        create_mesh((4,), ("data",), device="cpu")
    except ValueError as e:
        out["shape_error"] = str(e)
    return mesh


def run_replicate(inp, out, mesh):
    from tpu3dssf_torch.parallel import replicate
    from tpu3dssf_torch.train import TrainState, create_optimizer
    model = _lidar_model(inp)
    kw = dict(inp["opt_kw"])
    state = TrainState(model, create_optimizer(model.parameters(),
                                               kw.pop("name"), **kw))
    if mesh.rank == 1:    # rank 1 starts elsewhere; replicate fixes that
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    replicate(state, mesh)
    out["replicated"] = {k: _np(v) for k, v in model.state_dict().items()}


def run_eval(inp, out, mesh):
    from tpu3dssf_torch.cli.main_infer import pad_to
    from tpu3dssf_torch.losses import CELSLoss
    from tpu3dssf_torch.parallel import shard_batch
    from tpu3dssf_torch.train.loop import MetricAccumulator, make_eval_step
    model = _lidar_model(inp)
    step = make_eval_step(CELSLoss(weight=np.ones(16, np.float32)), 16, mesh)
    acc = MetricAccumulator(16, mesh=mesh)
    for b in inp["eval_batches"]:
        b = _batch(shard_batch(pad_to(b, 4), mesh))
        acc.add(step(model, b, torch.zeros(2, 1, 1, 1)))
    out["eval_local"] = acc.local_sums()
    out["eval_sums"] = acc.sums()
    out["eval_metrics"] = acc.metrics()


def run_train(inp, out, mesh):
    from tpu3dssf_torch.losses import CELSLoss
    from tpu3dssf_torch.parallel import replicate, shard_batch
    from tpu3dssf_torch.train import (TrainState, create_optimizer,
                                      make_train_step)
    loss_fn = CELSLoss(weight=np.ones(16, np.float32))
    for ga in (1, 2):
        model = _lidar_model(inp)
        kw = dict(inp["opt_kw"])
        state = replicate(TrainState(model, create_optimizer(
            model.parameters(), kw.pop("name"), **kw)), mesh)
        step = make_train_step(loss_fn, grad_accum=ga, mesh=mesh)
        b = _batch(shard_batch(inp["train_batch"], mesh, microbatches=ga))
        m = step(state, b, torch.zeros(2, 1, 1, 1))
        out[f"train{ga}"] = {
            "loss": float(m["loss"]), "correct": int(m["correct"]),
            "valid": int(m["valid"]), "step": state.step,
            "params": {k: _np(v) for k, v in model.state_dict().items()}}

    # DropPath at 0.5: the mesh step, each rank on its rows of the masks
    # drawn for the whole microbatch, and the one-process step on the whole
    # batch from the same state and seed
    import dataclasses
    from tpu3dssf_torch.models.lidar_only import LidarSegmentationModel
    cfg = inp["lidar_cfg"]
    cfg = dataclasses.replace(cfg, ptv3=dataclasses.replace(
        cfg.ptv3, drop_path=0.5))
    for ga in (1, 2):
        runs = {}
        for kind, run_mesh, batch in (
                ("mesh", mesh, shard_batch(inp["train_batch"], mesh,
                                           microbatches=ga)),
                ("one", None, inp["train_batch"])):
            model = LidarSegmentationModel(cfg)
            model.load_state_dict(inp["lidar_state"])
            kw = dict(inp["opt_kw"])
            state = TrainState(model, create_optimizer(
                model.parameters(), kw.pop("name"), **kw))
            step = make_train_step(loss_fn, dropout_seed=7, grad_accum=ga,
                                   mesh=run_mesh)
            b = _batch(batch)
            m = step(state, b, torch.zeros(b["points"].shape[0], 1, 1, 1))
            runs[kind] = {
                "loss": float(m["loss"]),
                "params": {k: _np(v) for k, v in model.state_dict().items()}}
        out[f"train_drop_path{ga}"] = runs


def run_tp(inp, out, mesh):
    from tpu3dssf_torch.models.vit import (VisionTransformer,
                                           prepare_tp_params)
    from tpu3dssf_torch.parallel import create_mesh, vit_tp_shardings
    tp = create_mesh((2,), ("model",), device="cpu")
    images = torch.from_numpy(inp["vit_images"]).requires_grad_()
    proj = torch.from_numpy(inp["vit_proj"])
    model = VisionTransformer(inp["vit_cfg"])
    model.load_state_dict(inp["vit_state"])
    full = model(images)["patch_features"]
    (g_full,) = torch.autograd.grad((full * proj).sum(), images)
    prepare_tp_params(model, model.config, tp)
    vit_tp_shardings(model, tp)
    out["tp_state"] = {k: _np(v) for k, v in model.state_dict().items()}
    got = model(images)["patch_features"]
    (g_tp,) = torch.autograd.grad((got * proj).sum(), images)
    out["tp_features"] = _np(got)
    out["tp_unsharded"] = _np(full)
    out["tp_grad"], out["tp_grad_unsharded"] = _np(g_tp), _np(g_full)
    out["tp_route"] = tp_routes(inp, tp)
    out["tp_w8a8"], out["tp_w8a8_unsharded"] = tp_w8a8(inp, tp)


def tp_w8a8(inp, tp):
    """The W8A8 ViT (``quantize_vit``) at TP = 2 and in one process, on
    the same weights and images: (sharded, unsharded) patch features."""
    from tpu3dssf_torch.models.vit import (VisionTransformer,
                                           prepare_tp_params, quantize_vit)
    from tpu3dssf_torch.parallel import vit_tp_shardings
    model = VisionTransformer(inp["vit_cfg"])
    model.load_state_dict(inp["vit_state"])
    quantize_vit(model)
    images = torch.from_numpy(inp["vit_images"])
    with torch.no_grad():
        want = model(images)["patch_features"]
        prepare_tp_params(model, model.config, tp)
        vit_tp_shardings(model, tp)
        got = model(images)["patch_features"]
    return _np(got), _np(want)


def tp_routes(inp, tp):
    """The attention calls of a one-block ViT with 16 heads of D = 16
    (``packed_head_groups=False``) unsharded and at TP = 2: (route, heads,
    contiguous qkv) per call."""
    from tpu3dssf_torch.models import vit
    from tpu3dssf_torch.parallel import vit_tp_shardings
    calls = []
    packed, flash = vit.flash_attention_packed, vit.flash_attention

    def rec_packed(qkv, bias, heads, *a):
        calls.append(("packed", heads, qkv.is_contiguous()))
        return packed(qkv, bias, heads, *a)

    def rec_flash(q, k, v, bias):
        calls.append(("bhnd", q.shape[2], True))
        return flash(q, k, v, bias)

    vit.flash_attention_packed, vit.flash_attention = rec_packed, rec_flash
    try:
        model = vit.VisionTransformer(inp["route_cfg"])
        model.load_state_dict(inp["route_state"])
        x = torch.from_numpy(inp["route_images"])
        with torch.no_grad():
            want = model(x)["patch_features"]
            vit.prepare_tp_params(model, model.config, tp)
            vit_tp_shardings(model, tp)
            got = model(x)["patch_features"]
    finally:
        vit.flash_attention_packed, vit.flash_attention = packed, flash
    return {"calls": calls, "max_diff": float((got - want).abs().max())}


def run_sp(inp, out):
    from tpu3dssf_torch.models.ptv3 import PTv3Block, SerializedCPE
    from tpu3dssf_torch.parallel import create_mesh, sp_block_apply
    seq = create_mesh((2,), ("seq",), device="cpu")
    x = torch.from_numpy(inp["sp_x"])
    mask = torch.from_numpy(inp["sp_mask"])
    n = x.shape[1] // 2
    lo = seq.coords["seq"] * n
    cpe = SerializedCPE(32, sp_axis="seq")
    cpe.load_state_dict(inp["sp_cpe_state"])
    with torch.no_grad(), seq:
        out["sp_cpe"] = _np(cpe(x[:, lo:lo + n], None, None,
                                mask[:, lo:lo + n]))
    block = PTv3Block(32, 2, 16, 2.0, sp_axis="seq")
    block.load_state_dict(inp["sp_block_state"])
    xg = x.clone().requires_grad_()
    y = sp_block_apply(block, xg, mask, seq, axis="seq")
    y.sum().backward()
    out["sp_block"], out["sp_grad"] = _np(y), _np(xg.grad)


def run_halos(out):
    """The SP halo exchange over this gloo group both ways: point to point
    (``_exchange``, the route NCCL takes) and by ``all_gather``, forward
    and backward, on this rank's seeded (B, n, C) span; with the
    point-to-point sends and receives each issued."""
    from tpu3dssf_torch.parallel import create_mesh
    from tpu3dssf_torch.parallel import sp
    seq = create_mesh((2,), ("seq",), device="cpu")
    index = seq.coords["seq"]
    gen = torch.Generator().manual_seed(10 + index)
    xs = torch.randn(3, 5, 4, generator=gen)
    ups = torch.randn(2, 3, 1, 4, generator=gen)
    group = seq.group("seq")
    for name, p2p in (("p2p", True), ("gather", False)):
        x = xs.clone().requires_grad_()
        before = sp.P2P_OPS
        left, right = sp._Halos.apply(x, group, 2, index, p2p)
        ((left * ups[0]).sum() + (right * ups[1]).sum()).backward()
        out[f"halo_{name}"] = (_np(left), _np(right), _np(x.grad),
                               sp.P2P_OPS - before)
    got = sp._exchange((xs[:, 0], xs[:, -1]), group, index, 2)
    out["halo_exchange"] = [_np(g) for g in got]
    out["halo_span"], out["halo_ups"] = _np(xs), _np(ups)


def run_multichip(inp, out, mesh):
    """``cli/multichip.py``'s three phases at its tiny sizes on this gloo
    mesh, with JAX's weights: the flagship's DP sequence, the TP ViT and
    the SP block."""
    from tpu3dssf_torch.cli import multichip
    from tpu3dssf_torch.models.vit import VisionTransformer
    with contextlib.redirect_stdout(io.StringIO()):
        out["mc_dp"] = multichip.dp_phase(mesh, multichip.TINY, reps=1,
                                          state_dict=inp["mc_state"],
                                          faults=True)
    vit = VisionTransformer(inp["vit_cfg"])
    vit.load_state_dict(inp["vit_state"])
    out["mc_tp"], tokens = multichip.tp_phase(
        mesh, multichip.TINY, vit=vit,
        images=torch.from_numpy(inp["vit_images"]))
    out["mc_vit"] = _np(tokens)
    out["mc_sp"], y, g = multichip.sp_phase(
        mesh, multichip.TINY, block_state=inp["sp_block_state"],
        x=torch.from_numpy(inp["sp_x"]), mask=torch.from_numpy(
            inp["sp_mask"]))
    out["mc_sp_out"], out["mc_sp_grad"] = _np(y), _np(g)


def run_main_infer(inp, out):
    from tpu3dssf_torch.cli.main_infer import main
    with contextlib.redirect_stdout(io.StringIO()) as said:
        metrics = main(["--config", inp["mesh_config"], "--device", "cpu"])
    out["infer_metrics"] = metrics
    out["infer_stdout"] = said.getvalue()


def main(directory):
    torch.set_num_threads(2)
    inp = torch.load(os.path.join(directory, "inputs.pt"),
                     weights_only=False)
    out = {}
    mesh = run_mesh(inp, out)
    run_replicate(inp, out, mesh)
    run_eval(inp, out, mesh)
    run_train(inp, out, mesh)
    run_tp(inp, out, mesh)
    run_sp(inp, out)
    run_halos(out)
    run_multichip(inp, out, mesh)
    run_main_infer(inp, out)
    out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in
                            ("jax", "jaxlib", "flax", "tpu3dssf"))
    torch.save(out, os.path.join(directory, f"rank{mesh.rank}.pt"))
    mesh.close()


if __name__ == "__main__":
    main(sys.argv[1])
