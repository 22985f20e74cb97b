"""The port's many-head ViT route (K8) and PTv3 window route (K6) vs the JAX
package's, on the CPU, on converted weights.

* A 2-layer ViT with H = 16 and C = 256 (D = 16, one 128-aligned group of
  8 heads) with ``packed_head_groups`` True (the packed route, K1) and False
  (the (B, N, H, D) route, K8) vs JAX's flash path in Pallas interpret mode.
* The route each attention call takes, port vs JAX, over a grid of (H, C,
  packed_head_groups) for the ViT and (H, C, K) for PTv3: both sides' kernel
  entry points are replaced by recorders, so nothing runs but the routing.
* A PTv3 and a fusion pipeline (the ViT above on its K8 route) at window 48
  vs JAX's plain attention path (``use_pallas=False``), forward and PTv3's
  parameter gradient.
* The converter on a many-head ViT and a fusion head at ViT-L's token width.

Tolerances: whole models at atol = rtol = 1e-4 (f32 sums over many layers
in another order); single layers at 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_convert import (port_config, port_pipeline_config, t,
                                      to_numpy_tree)
from tests.test_torch_pipeline import _slice_inputs, _tiny_config
from tests.test_torch_ptv3 import _inputs as _ptv3_inputs
from tpu3dssf.models import fusion as jfusion
from tpu3dssf.models import ptv3 as jptv3
from tpu3dssf.models import vit as jvit
from tpu3dssf.train import loop as jloop
from tpu3dssf_torch import convert
from tpu3dssf_torch.models import fusion, ptv3, vit
from tpu3dssf_torch.train import loop

# the modules (tpu3dssf.kernels re-exports functions of the same names)
jfa = importlib.import_module("tpu3dssf.kernels.flash_attention")
jwa = importlib.import_module("tpu3dssf.kernels.window_attention")
TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _many_head_vit(**kw):
    # RoPE + 4 registers, 15 patches + 5 prefix tokens (ragged N)
    return jvit.ViTConfig(patch_size=8, image_size=(24, 40), hidden_size=256,
                          num_layers=2, num_heads=16, num_register_tokens=4,
                          use_rope=True, ln_eps=1e-5, **kw)


@pytest.mark.parametrize("packed_head_groups", [True, False])
def test_many_head_vit_matches_jax_flash_path(rng, packed_head_groups):
    cfg = _many_head_vit(use_flash=True,
                         packed_head_groups=packed_head_groups)
    images = rng.normal(size=(2, 24, 40, 3)).astype(np.float32)
    params = to_numpy_tree(jax.jit(jvit.VisionTransformer(cfg).init)(
        jax.random.PRNGKey(0), images))
    for i in range(cfg.num_layers):   # O(1) LayerScale: the blocks matter
        for ls in ("ls1", "ls2"):
            blk = params["params"][f"block{i}"][ls]
            blk["gamma"] = rng.normal(size=blk["gamma"].shape).astype(
                np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jvit.VisionTransformer(cfg).apply(params, images)
    model = vit.VisionTransformer(port_config(cfg, vit.ViTConfig))
    assert model.config.packed_head_groups == packed_head_groups
    model.load_state_dict(convert.vit_state_dict_from_flax(params, cfg))
    with torch.no_grad():
        got = model(t(images))
    for key in ("patch_features", "global_features"):
        assert np.abs(np.asarray(want[key])).max() > 0.1
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **MODEL_TOL)


def _recorder(calls, name, shape_of):
    def record(*args, **kwargs):
        calls.append(name)
        return shape_of(*args)
    return record


def _jax_zeros(shape_of):
    return lambda *a: jnp.zeros(shape_of(*a), a[0].dtype)


def _torch_zeros(shape_of):
    return lambda *a: torch.zeros(shape_of(*a), dtype=a[0].dtype)


def _bnc(qkv, *_):
    return qkv.shape[:-1] + (qkv.shape[-1] // 3,)


def _like_q(q, *_):
    return q.shape


@pytest.mark.parametrize("packed_head_groups", [True, False])
@pytest.mark.parametrize("H,C", [(6, 384), (16, 1024), (16, 256), (12, 768),
                                 (16, 128)])
def test_vit_block_routes_as_jax(monkeypatch, packed_head_groups, H, C):
    """(16, 128) has no 128-aligned head group: K8 whatever the flag."""
    cfg = jvit.ViTConfig(hidden_size=C, num_heads=H, num_layers=1,
                         use_flash=True, packed_head_groups=packed_head_groups)
    x = np.zeros((1, 8, C), np.float32)
    jax_calls, port_calls = [], []
    for name, shape_of in (("flash_attention_packed", _bnc),
                           ("flash_attention", _like_q)):
        monkeypatch.setattr(jfa, name, _recorder(
            jax_calls, name, _jax_zeros(shape_of)))
        monkeypatch.setattr(vit, name, _recorder(
            port_calls, name, _torch_zeros(shape_of)))
    block = jvit.ViTBlock(cfg)
    params = block.init(jax.random.PRNGKey(0), x)
    del jax_calls[:]
    block.apply(params, x)
    port = vit.ViTBlock(port_config(cfg, vit.ViTConfig))
    with torch.no_grad():
        port(t(x), None, torch.zeros(1, 1, 8))
    assert port_calls == jax_calls and len(jax_calls) == 1
    want = ("flash_attention" if H > 8 and (
        jfa.pick_head_group(H, C) is None or not packed_head_groups)
        else "flash_attention_packed")
    assert jax_calls == [want]


ROUTES = {"flash_attention_packed": "packed",
          "window_attention_packed": "window_packed",
          "window_attention": "window"}


@pytest.mark.parametrize("H,C,K", [
    (2, 32, 1024), (4, 64, 1024), (8, 128, 1024), (16, 256, 1024),
    (32, 512, 1024), (16, 128, 128), (12, 192, 256), (2, 32, 48),
    (8, 128, 48), (32, 512, 48), (4, 64, 96)])
def test_serialized_attention_routes_as_jax(monkeypatch, H, C, K):
    x = np.zeros((1, K, C), np.float32)
    mask = np.ones((1, K), bool)
    jax_calls, port_calls = [], []

    def qkv_shape(qkv, *_):
        return _bnc(qkv)

    def q_shape(q, *_):
        return q.shape

    for name, shape_of, jmod in (
            ("flash_attention_packed", qkv_shape, jfa),
            ("window_attention_packed", qkv_shape, jwa),
            ("window_attention", q_shape, jptv3)):
        monkeypatch.setattr(jmod, name, _recorder(
            jax_calls, ROUTES[name], _jax_zeros(shape_of)))
        monkeypatch.setattr(ptv3, name, _recorder(
            port_calls, ROUTES[name], _torch_zeros(shape_of)))
    attn = jptv3.SerializedAttention(C, H, K, use_pallas=True)
    params = attn.init(jax.random.PRNGKey(0), x, None, None, mask)
    del jax_calls[:]
    attn.apply(params, x, None, None, mask)
    with torch.no_grad():
        ptv3.SerializedAttention(C, H, K)(t(x), None, None, t(mask))
    assert port_calls == jax_calls == [ptv3.attention_route(C, H, K)]


def _window48_config(**kw):
    base = dict(enc_depths=(1, 2, 1), enc_channels=(16, 32, 64),
                enc_heads=(1, 2, 4), enc_window=(48, 48, 48),
                dec_depths=(1, 1), dec_channels=(16, 32), dec_heads=(1, 2),
                dec_window=(48, 48), use_pallas=False)
    base.update(kw)
    return jptv3.PTv3Config(**base)


def test_ptv3_at_window_48_matches_jax(rng):
    """Every stage on the (W, K, H, D) route; forward and the parameter
    gradient of a fixed random projection of the output (the K4/K5 rule)
    vs JAX's jnp path and its autodiff."""
    jcfg = _window48_config()
    feat, grid, mask = _ptv3_inputs(rng, True, N=144)
    jmodel = jptv3.PointTransformerV3(jcfg)
    params = to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), feat, grid, mask))
    proj = rng.normal(size=(2, 144, 16)).astype(np.float32)

    def jloss(p):
        out, _ = jmodel.apply(p, feat, grid, mask)
        return jnp.sum(out * proj), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    model = ptv3.PointTransformerV3(port_config(jcfg, ptv3.PTv3Config))
    model.load_state_dict(convert.state_dict_from_flax(params))
    assert {ptv3.attention_route(c, h, 48) for c, h in zip(
        jcfg.enc_channels, jcfg.enc_heads)} == {"window"}
    got, _ = model(t(feat), t(grid), t(mask))
    (got * t(proj)).sum().backward()
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    wgrads = convert.state_dict_from_flax(to_numpy_tree(jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), wgrads[name].numpy(),
                                   err_msg=name, **MODEL_TOL)


def test_fusion_pipeline_at_window_48_with_the_k8_vit_matches_jax(rng):
    """images → the many-head ViT on its (B, N, H, D) route → tokens →
    pipeline at window 48 → logits, vs JAX (its ViT on the einsum path,
    its PTv3 on the jnp path: the same functions)."""
    vcfg = _many_head_vit(scan_layers=True)
    pcfg = jfusion.PipelineConfig(
        fusion=jfusion.FusionConfig(point_feat_dim=16, patch_tok_dim=256,
                                    hidden_dims=(32, 16), output_dim=16,
                                    patch_size=8, encoder_size=(24, 40)),
        ptv3=_window48_config(enc_depths=(1, 2), enc_channels=(16, 32),
                              enc_heads=(1, 2), enc_window=(48, 48),
                              dec_depths=(1,), dec_channels=(16,),
                              dec_heads=(1,), dec_window=(48,)),
        voxel_size=0.5, voxel_capacity=144)
    batch, images = _slice_inputs(rng)
    jvit_model = jvit.VisionTransformer(vcfg)
    vparams = to_numpy_tree(jvit_model.init(jax.random.PRNGKey(1),
                                            jnp.zeros((1, 24, 40, 3))))
    vparams, fcfg = jvit.fold_layerscale(vparams, vcfg)
    vparams = to_numpy_tree(vparams)
    jtokens = jloop.make_image_encode_fn(jvit.VisionTransformer(fcfg),
                                         vparams, (24, 40))(
        jnp.asarray(images))
    jpipe = jfusion.SegmentationPipeline(pcfg)
    jargs = [jnp.asarray(batch[k]) for k in ("points", "point_valid")]
    jargs += [jtokens] + [jnp.asarray(batch[k])
                          for k in ("cam_intrinsics", "lidar2cam")]
    params = to_numpy_tree(jax.jit(jpipe.init)(jax.random.PRNGKey(2),
                                               *jargs))
    want = jax.jit(jpipe.apply)(params, *jargs)

    pvit = vit.VisionTransformer(port_config(fcfg, vit.ViTConfig,
                                             packed_head_groups=False))
    pvit.load_state_dict(convert.vit_state_dict_from_flax(vparams, fcfg))
    tokens = loop.make_image_encode_fn(pvit, (24, 40))(t(images))
    np.testing.assert_allclose(tokens.numpy(), np.asarray(jtokens),
                               **MODEL_TOL)
    model = fusion.SegmentationPipeline(port_pipeline_config(pcfg))
    model.load_state_dict(convert.pipeline_state_dict_from_flax(params))
    tb = {k: t(v) for k, v in batch.items()}
    with torch.no_grad():
        got = model(tb["points"], tb["point_valid"], tokens,
                    tb["cam_intrinsics"], tb["lidar2cam"])
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("scan", [True, False])
def test_converter_carries_a_many_head_vit(rng, scan):
    """H = 16 ViT trees, stacked (``scan_layers``) and unrolled, convert to
    the port's layout with the (3C, C) qkv projection intact."""
    from tpu3dssf.train.convert import convert_tree

    cfg = _many_head_vit(scan_layers=True)
    params = to_numpy_tree(jvit.VisionTransformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 24, 40, 3))))
    tree = params if scan else to_numpy_tree(convert_tree(params,
                                                          to_scan=False))
    sd = convert.vit_state_dict_from_flax(tree, cfg)
    assert tuple(sd["blocks.1.qkv.weight"].shape) == (768, 256)
    model = vit.VisionTransformer(port_config(cfg, vit.ViTConfig))
    model.load_state_dict(sd)
    stacked = params["params"]["blocks"]["qkv"]["kernel"]
    np.testing.assert_array_equal(model.blocks[1].qkv.weight.detach().numpy(),
                                  stacked[1].T)


def test_fusion_head_at_vit_l_width_matches_jax(rng):
    """The 64 + 1024 → 256 → 64 → 16 head of a ViT-L fusion frame."""
    from tests.test_torch_serialization_voxel import _cameras

    cfg = jfusion.FusionConfig(patch_tok_dim=1024, patch_size=8,
                               encoder_size=(24, 40))
    tokens = rng.normal(size=(1, 6, 15, 1024)).astype(np.float32)
    feats = rng.normal(size=(1, 64, 64)).astype(np.float32)
    xyz = (rng.normal(size=(1, 64, 3)) * 8).astype(np.float32)
    raw = np.concatenate([xyz, rng.random((1, 64, 1))], -1).astype(
        np.float32)
    K, Rt = _cameras(rng, 1)
    args = (tokens, feats, raw, rng.random((1, 64)) > 0.2, K, Rt)
    jargs = [jnp.asarray(a) for a in args]
    jmodel = jfusion.FeatureFusionModel(cfg)
    params = to_numpy_tree(jmodel.init(jax.random.PRNGKey(0), *jargs))
    model = fusion.FeatureFusionModel(port_config(cfg, fusion.FusionConfig))
    model.load_state_dict(convert.state_dict_from_flax(params))
    assert tuple(model.mlp0.weight.shape) == (256, 64 + 1024)
    with torch.no_grad():
        got = model(*(t(a) for a in args))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.apply(params, *jargs)),
                               **TOL)


def test_cli_builds_the_vit_l_fusion_frame(tmp_path):
    """``image_encoder: dinov3_large`` gives the ViT-L preset and a fusion
    head over 1024-wide tokens; the CLI exposes no packed_head_groups."""
    import yaml
    from tpu3dssf_torch.cli import common

    path = _tiny_config(tmp_path)
    raw = yaml.safe_load(open(path))
    raw["train_params"]["image_encoder"] = "dinov3_large"
    open(path, "w").write(yaml.safe_dump(raw))
    cfg = common.load_config(path)
    vit_cfg = vit.dinov3_large()
    assert (vit_cfg.hidden_size, vit_cfg.num_heads, vit_cfg.num_layers,
            vit_cfg.packed_head_groups) == (1024, 16, 24, True)
    model, pipe = common.build_pipeline(cfg, vit_cfg, "cpu")
    assert pipe.fusion.patch_tok_dim == 1024
    assert tuple(model.fusion.mlp0.weight.shape) == (256, 64 + 1024)
    assert tuple(common.zero_tokens(cfg, vit_cfg, 2).shape) == (
        2, 6, vit_cfg.num_patches, 1024)
