"""The port's training stack vs the JAX package's, on the CPU.

Optimizers, schedules, clipping, the non-finite guard and the plateau are
held against optax (the JAX package's ``create_optimizer`` and
``create_schedule``) over the same gradient sequence; one train step of a
small fusion pipeline against JAX's ``make_train_step`` on converted
weights; then the port's own DropPath, grad accumulation, checkpoints and
``main_train`` CLI.

Tolerances, each relative to the largest magnitude of the tensor compared:
the updates of SGD 1e-6 and of Adam/AdamW 1e-5 (optax evaluates its
schedules in f32, and Adam's bias corrections 1 − βᵗ in f32, which are off
by up to 7e-6 relative over the first steps; torch uses float64); learning
rates 1e-6 of the base rate; the train step's loss, every gradient and
every updated parameter 1e-4 (f32 sums over many layers in another order);
the microbatch mean 1e-6.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_convert import port_pipeline_config, t, to_numpy_tree
from tests.test_torch_pipeline import _slice_inputs, _tiny_config
from tpu3dssf import losses as jlosses
from tpu3dssf.models import fusion as jfusion
from tpu3dssf.models import ptv3 as jptv3
from tpu3dssf.train import loop as jloop
from tpu3dssf.train import state as jstate
from tpu3dssf_torch import convert, losses
from tpu3dssf_torch.models import fusion
from tpu3dssf_torch.models.ptv3 import DropPath
from tpu3dssf_torch.train import (TrainState, create_optimizer,
                                  create_schedule, latest_checkpoint,
                                  make_train_step, restore_checkpoint,
                                  save_checkpoint)



def _assert_rel(got, want, tol=1e-4, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err} vs scale {scale}"


def _run_both(rng, n, values=None, nan_at=(), scale=1.0, **kw):
    """n updates of create_optimizer(**kw) in optax and in the port from
    the same params and gradients; returns both parameter trajectories.
    The params start small, so the updates, not the f32 rounding of the
    params, set the scale of what is compared."""
    p0 = {"w": (rng.normal(size=(3, 4)) * 0.01).astype(np.float32),
          "b": (rng.normal(size=(5,)) * 0.01).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * scale).astype(np.float32)
              for k, v in p0.items()} for _ in range(n)]
    for i in nan_at:
        grads[i]["w"][0, 0] = np.nan
    values = values if values is not None else [1.0] * n

    tx = jstate.create_optimizer(**kw)
    params = jax.tree.map(jnp.asarray, p0)
    st = tx.init(params)
    want = []
    for g, v in zip(grads, values):
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, params,
                            value=jnp.float32(v))
        params = optax.apply_updates(params, upd)
        want.append({k: np.asarray(x) for k, x in params.items()})

    tp = {k: torch.nn.Parameter(t(v)) for k, v in p0.items()}
    opt = create_optimizer([tp["w"], tp["b"]], **kw)
    got = []
    for g, v in zip(grads, values):
        for k in tp:
            tp[k].grad = t(g[k])
        opt.step(value=torch.tensor(v))
        got.append({k: x.detach().numpy().copy() for k, x in tp.items()})
    return p0, want, got


def _assert_trajectories(p0, want, got, tol=1e-6):
    # compare what moved (p_t − p_0): the updates themselves
    for i, (w, g) in enumerate(zip(want, got)):
        for k in p0:
            _assert_rel(g[k] - p0[k], w[k] - p0[k], tol,
                        what=f"update {i} of {k}")


def _tol(name):
    return 1e-5 if name.startswith("Adam") else 1e-6


OPTIMIZERS = [dict(name="AdamW", weight_decay=1e-2),
              dict(name="Adam", weight_decay=1e-2),
              dict(name="SGD", momentum=0.9, nesterov=True),
              dict(name="SGD", momentum=0.0)]
SCHEDULERS = ("none", "StepLR", "CosineAnnealingLR",
              "CosineAnnealingWarmRestarts", "ReduceLROnPlateau")


@pytest.mark.parametrize("opt", OPTIMIZERS,
                         ids=lambda o: f"{o['name']}-{o.get('momentum', '')}")
@pytest.mark.parametrize("sched", SCHEDULERS)
def test_optimizer_and_schedule_match_optax(rng, opt, sched):
    p0, want, got = _run_both(
        rng, 5, learning_rate=0.05, lr_scheduler=sched, steps_per_epoch=1,
        num_epochs=3, values=[1.0, 0.9, 0.95, 0.97, 0.99], **opt)
    _assert_trajectories(p0, want, got, _tol(opt["name"]))


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_schedule_closed_forms_match_optax(sched):
    """Learning rate at every update count, restarts of SGDR included
    (periods 10, 20, 40, 80 updates at one step per epoch)."""
    f = create_schedule(sched, steps_per_epoch=1, num_epochs=30)
    want = jstate.create_schedule(sched, 0.01, 1, 30)
    for c in range(0, 170, 3):
        w = want(c) if callable(want) else want
        # optax evaluates its closed form in f32: 1e-6 of the base rate
        np.testing.assert_allclose(0.01 * f(c), float(w), rtol=1e-6,
                                   atol=1e-8)


def test_global_norm_clip_matches_optax(rng):
    # large gradients trigger the clip, small ones pass unclipped
    for scale in (50.0, 0.01):
        p0, want, got = _run_both(rng, 4, name="SGD", learning_rate=0.1,
                                  momentum=0.9, grad_clip=1.0, scale=scale)
        _assert_trajectories(p0, want, got)
    p0, want, got = _run_both(rng, 4, name="AdamW", learning_rate=0.01,
                              weight_decay=1e-3, grad_clip=1.0, scale=50.0)
    _assert_trajectories(p0, want, got, _tol("AdamW"))


def test_skip_nonfinite_matches_optax(rng):
    p0, want, got = _run_both(rng, 6, name="AdamW", learning_rate=0.01,
                              lr_scheduler="CosineAnnealingLR",
                              steps_per_epoch=2, num_epochs=3,
                              skip_nonfinite=True, nan_at=(1, 2))
    _assert_trajectories(p0, want, got, _tol("AdamW"))
    np.testing.assert_array_equal(got[2]["w"], got[0]["w"])  # skipped


def test_plateau_with_nonfinite_values_matches_optax(rng):
    """Epochs of 2 updates; a flat loss with NaN batches must reduce the
    lr after 10 non-improving epochs, with the NaNs invisible."""
    n = 40
    values = [1.0 - 0.01 * min(i, 6) for i in range(n)]
    for i in (3, 11, 20, 21):
        values[i] = float("nan")
    p0, want, got = _run_both(rng, n, name="SGD", learning_rate=0.1,
                              momentum=0.0, lr_scheduler="ReduceLROnPlateau",
                              steps_per_epoch=2, num_epochs=20,
                              values=values, skip_nonfinite=True)
    _assert_trajectories(p0, want, got)
    first = np.abs(got[0]["w"] - p0["w"]).mean()
    last = np.abs(got[-1]["w"] - got[-2]["w"]).mean()
    assert last < 0.2 * first                 # the plateau fired


def _jax_pipeline_config():
    return jfusion.PipelineConfig(
        fusion=jfusion.FusionConfig(point_feat_dim=16, patch_tok_dim=32,
                                    hidden_dims=(32, 16), output_dim=16,
                                    patch_size=8, encoder_size=(24, 40)),
        ptv3=jptv3.PTv3Config(
            enc_depths=(1, 2), enc_channels=(16, 32), enc_heads=(1, 2),
            enc_window=(32, 32), dec_depths=(1,), dec_channels=(16,),
            dec_heads=(1,), dec_window=(32,), use_pallas=False),
        voxel_size=0.5, voxel_capacity=128)


OPT_KW = dict(name="AdamW", learning_rate=1e-3, weight_decay=1e-3,
              lr_scheduler="CosineAnnealingLR", steps_per_epoch=24,
              num_epochs=20, grad_clip=1.0)


def test_train_step_matches_jax(rng, monkeypatch):
    """One AdamW + cosine + clip step (the r3 config's recipe) at f32:
    loss, every gradient and every updated parameter."""
    # JAX's default Lovász sort quantises its key, which reorders near-tied
    # errors and changes the rank-based gradient; the port sorts exactly
    monkeypatch.setattr(jlosses, "lovasz_softmax", functools.partial(
        jlosses.lovasz_softmax, exact_sort=True))
    pcfg = _jax_pipeline_config()
    batch, _ = _slice_inputs(rng)
    tokens = rng.normal(size=(2, 6, 15, 32)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jpipe = jfusion.SegmentationPipeline(pcfg)
    params = to_numpy_tree(jax.jit(jpipe.init)(
        jax.random.PRNGKey(2), jb["points"], jb["point_valid"],
        jnp.asarray(tokens), jb["cam_intrinsics"], jb["lidar2cam"]))
    jloss = jlosses.CELSLoss(weight=np.ones(16, np.float32))

    def loss_of(p):
        logits = jpipe.apply(p, jb["points"], jb["point_valid"],
                             jnp.asarray(tokens), jb["cam_intrinsics"],
                             jb["lidar2cam"])
        return jloss(logits, jb["labels"], jb["mask"]).total

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_of))(params)
    kw = dict(OPT_KW)
    jst = jstate.create_train_state(
        jpipe, params, jstate.create_optimizer(kw.pop("name"), **{
            k: v for k, v in kw.items()}))
    jst, jm = jloop.make_train_step(jloss)(jst, jb, jnp.asarray(tokens))

    model = fusion.SegmentationPipeline(port_pipeline_config(pcfg))
    model.load_state_dict(convert.pipeline_state_dict_from_flax(params))
    tb = {k: t(v) for k, v in batch.items()}
    loss_fn = losses.CELSLoss(weight=np.ones(16))
    out = loss_fn(model(tb["points"], tb["point_valid"], t(tokens),
                        tb["cam_intrinsics"], tb["lidar2cam"]),
                  tb["labels"], tb["mask"])
    out.total.backward()
    _assert_rel(out.total.detach().numpy(), np.asarray(want_loss),
                what="loss")
    jg = convert.pipeline_state_dict_from_flax(
        {"params": to_numpy_tree(want_grads["params"])})
    names = dict(model.named_parameters())
    assert set(jg) == set(names)
    for k, p in names.items():
        _assert_rel(p.grad.numpy(), jg[k].numpy(), what=f"grad {k}")

    kw = dict(OPT_KW)
    state = TrainState(model, create_optimizer(
        model.parameters(), kw.pop("name"), **kw))
    m = make_train_step(loss_fn)(state, tb, t(tokens))
    _assert_rel(m["loss"].numpy(), np.asarray(jm["loss"]), what="metric")
    assert int(m["correct"]) == int(jm["correct"])
    assert int(m["valid"]) == int(jm["valid"])
    jp = convert.pipeline_state_dict_from_flax(to_numpy_tree(jst.params))
    for k, p in model.state_dict().items():
        got, want = p.numpy(), jp[k].numpy()
        if k.endswith("attn.qkv.bias"):
            # the key bias adds q·b_k to every score of a query row, which
            # softmax ignores: its gradient is 0 in exact arithmetic and
            # rounding noise in both frameworks, which Adam's first step
            # (g / (|g| + eps)) turns into an O(lr) update of either sign
            C = got.shape[0] // 3
            g = jg[k].numpy()
            assert np.abs(g[C:2 * C]).max() <= 1e-6 * np.abs(g).max()
            assert np.abs(names[k].grad.numpy()[C:2 * C]).max() <= \
                1e-6 * np.abs(g).max()
            got, want = np.delete(got, np.s_[C:2 * C]), \
                np.delete(want, np.s_[C:2 * C])
        _assert_rel(got, want, what=f"param {k}")
    assert state.step == 1


def _port_small_state(seed=0, drop_path=0.0):
    pcfg = port_pipeline_config(_jax_pipeline_config())
    import dataclasses
    pcfg = dataclasses.replace(pcfg, ptv3=dataclasses.replace(
        pcfg.ptv3, drop_path=drop_path))
    from tpu3dssf_torch.models.layers import init_weights
    model = init_weights(fusion.SegmentationPipeline(pcfg), seed)
    kw = dict(OPT_KW)
    return TrainState(model, create_optimizer(
        model.parameters(), kw.pop("name"), **kw))


def _port_batch(rng, B=2):
    batch, _ = _slice_inputs(rng, B=B)
    tokens = t(rng.normal(size=(B, 6, 15, 32)).astype(np.float32))
    return {k: t(v) for k, v in batch.items()}, tokens


def test_grad_accum_is_the_mean_of_microbatch_grads(rng):
    loss_fn = losses.CELSLoss(weight=np.ones(16))
    batch, tokens = _port_batch(rng, B=4)
    a = _port_small_state()
    ma = make_train_step(loss_fn, grad_accum=2)(a, batch, tokens)

    b = _port_small_state()
    grads, outs = [], []
    for i in range(2):
        hb = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        b.optimizer.zero_grad()
        out = loss_fn(b.model(hb["points"], hb["point_valid"],
                              tokens[2 * i:2 * i + 2], hb["cam_intrinsics"],
                              hb["lidar2cam"]), hb["labels"], hb["mask"])
        out.total.backward()
        outs.append(out)
        grads.append([p.grad.clone() for p in b.model.parameters()])
    for p, g0, g1 in zip(b.model.parameters(), *grads):
        p.grad = (g0 + g1) * 0.5
    b.apply_gradients(value=(outs[0].total + outs[1].total) / 2)
    np.testing.assert_allclose(
        float(ma["loss"]),
        (float(outs[0].total.detach()) + float(outs[1].total.detach())) / 2,
        rtol=1e-6)
    assert int(ma["correct"]) == sum(int(o.num_correct) for o in outs)
    assert int(ma["valid"]) == sum(int(o.num_valid) for o in outs)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(loss_fn, grad_accum=3)(a, batch, tokens)


def test_drop_path():
    x = torch.randn(6, 5, 3)
    assert DropPath(0.0)(x, torch.Generator().manual_seed(0)) is x
    assert DropPath(0.4)(x, None) is x
    dp = DropPath(0.5)
    a = dp(x, torch.Generator().manual_seed(7))
    b = dp(x, torch.Generator().manual_seed(7))
    c = dp(x, torch.Generator().manual_seed(8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    kept = (a != 0).flatten(1)
    assert (kept.all(1) | ~kept.any(1)).all()      # one draw per sample
    assert 0 < int(kept.all(1).sum()) < 6
    torch.testing.assert_close(a[kept.all(1)], x[kept.all(1)] * 2.0)


def test_train_step_with_drop_path_is_seeded(rng):
    loss_fn = losses.CELSLoss(weight=np.ones(16))
    batch, tokens = _port_batch(rng)
    runs = []
    for _ in range(2):
        s = _port_small_state(drop_path=0.5)
        step = make_train_step(loss_fn, dropout_seed=7)
        runs.append([float(step(s, batch, tokens)["loss"])
                     for _ in range(3)])
    assert runs[0] == runs[1]                        # same seed, same masks
    assert len(set(runs[0])) > 1                      # masks move per step


def test_train_step_on_the_frozen_encoders_own_tokens(rng):
    """The tokens come from ``make_image_encode_fn`` under inference mode:
    a train step must still run backward through the fusion head."""
    from tests.test_torch_convert import port_config
    from tpu3dssf.models import vit as jvit
    from tpu3dssf_torch.models import vit
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.train.loop import make_image_encode_fn

    vcfg = port_config(jvit.ViTConfig(
        patch_size=8, image_size=(24, 40), hidden_size=32, num_layers=1,
        num_heads=2, num_register_tokens=4, use_rope=True, ln_eps=1e-5),
        vit.ViTConfig)
    enc = vit.fold_layerscale(init_weights(vit.VisionTransformer(vcfg), 1))
    batch, images = _slice_inputs(rng)
    tokens = make_image_encode_fn(enc, (24, 40))(t(images))
    assert tokens.is_inference()
    state = _port_small_state()
    before = [p.detach().clone() for p in state.model.parameters()]
    m = make_train_step(losses.CELSLoss(weight=np.ones(16)))(
        state, {k: t(v) for k, v in batch.items()}, tokens)
    assert np.isfinite(float(m["loss"]))
    changed = sum(not torch.equal(a, p.detach()) for a, p in
                  zip(before, state.model.parameters()))
    assert changed == len(before)


def test_checkpoint_round_trip_and_resume(tmp_path, rng):
    loss_fn = losses.CELSLoss(weight=np.ones(16))
    batch, tokens = _port_batch(rng)
    a = _port_small_state()
    step = make_train_step(loss_fn)
    step(a, batch, tokens)
    for s in range(5):
        save_checkpoint(str(tmp_path), s, a, extra={"best_acc": 0.5,
                                                    "epoch": s})
    assert sorted(os.listdir(tmp_path)) == ["2", "3", "4"]   # latest 3
    assert latest_checkpoint(str(tmp_path)) == 4

    b = _port_small_state(seed=9)
    b, extra, got_step = restore_checkpoint(str(tmp_path), None, b)
    assert got_step == 4 and extra == {"best_acc": 0.5, "epoch": 4}
    assert b.step == a.step == 1
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    # resumed training continues exactly: schedule count and Adam moments
    ma, mb = step(a, batch, tokens), step(b, batch, tokens)
    assert float(ma["loss"]) == float(mb["loss"])
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)

    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), None, b)
    import dataclasses
    other = port_pipeline_config(_jax_pipeline_config())
    other = dataclasses.replace(other, ptv3=dataclasses.replace(
        other.ptv3, enc_channels=(16, 48)))
    c = TrainState(fusion.SegmentationPipeline(other), b.optimizer)
    with pytest.raises(FileNotFoundError, match="does not match"):
        restore_checkpoint(str(tmp_path), None, c)


def test_train_model_epochs_checkpoints_and_profiler_trace(tmp_path, rng):
    from tpu3dssf_torch.train import train_model
    host, _ = _slice_inputs(rng)
    tokens = t(rng.normal(size=(2, 6, 15, 32)).astype(np.float32))
    loaders = {"train": [dict(host) for _ in range(3)],
               "val": [dict(host)]}
    state = _port_small_state()
    tr, val = train_model(state, loaders, losses.CELSLoss(np.ones(16)),
                          None, 16, num_epochs=1, save_dir=str(tmp_path),
                          zero_tokens_fn=lambda b: tokens,
                          profile_dir=str(tmp_path / "prof"),
                          profile_steps=(1, 2))
    assert state.step == 3 and len(tr) == len(val) == 1
    assert (tmp_path / "prof" / "train_trace.json").stat().st_size > 0
    assert latest_checkpoint(str(tmp_path)) == 0
    assert latest_checkpoint(str(tmp_path / "last")) == 0


def test_main_train_runs_and_resumes_on_cpu(tmp_path, capsys):
    import yaml
    from tpu3dssf_torch.cli.main_train import main
    from tpu3dssf_torch.kernels.modules import flash_attention as fa
    from tpu3dssf_torch.kernels.modules import window_attention as wa

    cfg_path = _tiny_config(tmp_path)
    cfg = yaml.safe_load(open(cfg_path))
    cfg["train_params"]["max_num_epochs"] = 1
    cfg["tpu_params"]["synthetic_samples"] = 4
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    counts = (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.BWD_LAUNCHES,
              wa.LSE_LAUNCHES, wa.BWD_LAUNCHES)
    state, tr, val = main(["--config", cfg_path, "--device", "cpu"])
    assert (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.BWD_LAUNCHES,
            wa.LSE_LAUNCHES, wa.BWD_LAUNCHES) == counts   # CPU: plain only
    assert len(tr) == len(val) == 1 and state.step == 2
    ckpt = tmp_path / "ckpt"
    assert (ckpt / "training_history.json").exists()
    assert latest_checkpoint(str(ckpt / "last")) == 0
    text = capsys.readouterr().out
    assert "EVALUATION METRICS" in text and "Best val Acc" in text

    cfg["train_params"]["max_num_epochs"] = 2
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    state, tr, val = main(["--config", cfg_path, "--device", "cpu",
                           "--resume"])
    assert "Resumed full train state at epoch 1" in capsys.readouterr().out
    assert len(tr) == 1 and state.step == 4          # 2 restored + 2 new
    assert state.optimizer.scheduler.last_epoch == 4
    assert latest_checkpoint(str(ckpt / "last")) == 1


def test_main_train_refuses_to_fall_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would use it")
    from tpu3dssf_torch.cli.main_train import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", _tiny_config(tmp_path)])
