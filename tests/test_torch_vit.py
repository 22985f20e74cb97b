"""The port's ViT and image preprocessing vs the JAX package's.

Tolerances: whole ViT at atol = rtol = 1e-4 (f32 sums over many layers in
another order); resize matrices at 1e-6 (both built in f32 from the same
formula); f32 preprocessing at 1e-5; bf16 preprocessing within one bf16
ulp (rtol 2^-7), since only the f32 summation order before the final
rounding differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_convert import port_config, t, to_numpy_tree
from tpu3dssf.models import vit as jvit
from tpu3dssf_torch import convert
from tpu3dssf_torch.models import vit

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


def _dinov3_like(**kw):
    # RoPE + 4 registers, D = 16, 15 patches + 5 prefix tokens (ragged N)
    return jvit.ViTConfig(patch_size=8, image_size=(24, 40), hidden_size=64,
                          num_layers=2, num_heads=4, num_register_tokens=4,
                          use_rope=True, ln_eps=1e-5, **kw)


def _dinov2_like(**kw):
    return jvit.ViTConfig(patch_size=8, image_size=(24, 40), hidden_size=64,
                          num_layers=2, num_heads=4, use_rope=False, **kw)


def _params(rng, cfg, images):
    p = to_numpy_tree(jax.jit(jvit.VisionTransformer(cfg).init)(
        jax.random.PRNGKey(0), images))
    # O(1) LayerScale gammas, so the blocks (not the 1e-5 init) matter
    blocks = p["params"]["blocks"] if cfg.scan_layers else None
    for i in range(cfg.num_layers):
        blk = (blocks if blocks is not None else p["params"][f"block{i}"])
        for ls in ("ls1", "ls2"):
            blk[ls]["gamma"] = rng.normal(
                size=blk[ls]["gamma"].shape).astype(np.float32)
        if blocks is not None:
            break
    return p


def _port(cfg, params, **kw):
    model = vit.VisionTransformer(port_config(cfg, vit.ViTConfig), **kw)
    model.load_state_dict(convert.vit_state_dict_from_flax(params, cfg))
    return model


def _check(model, jmodel, params, images):
    want = jmodel.apply(params, images)
    with torch.no_grad():
        got = model(t(images))
    for key in ("patch_features", "global_features"):
        assert np.abs(np.asarray(want[key])).max() > 0.1
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **MODEL_TOL)


@pytest.mark.parametrize("make_cfg,scan,compat", [
    (_dinov3_like, True, False), (_dinov3_like, False, True),
    (_dinov2_like, False, False)])
def test_vit_matches_before_and_after_fold(rng, make_cfg, scan, compat):
    cfg = make_cfg(scan_layers=scan)
    images = rng.normal(size=(2, 24, 40, 3)).astype(np.float32)
    params = _params(rng, cfg, images)
    jmodel = jvit.VisionTransformer(cfg, register_slice_compat=compat)
    model = _port(cfg, params, register_slice_compat=compat)
    _check(model, jmodel, params, images)

    folded, fcfg = jvit.fold_layerscale(params, cfg)
    folded = to_numpy_tree(folded)
    jfolded = jvit.VisionTransformer(fcfg, register_slice_compat=compat)
    _check(vit.fold_layerscale(model), jfolded, folded, images)
    assert model.config.layerscale_init is None
    _check(_port(fcfg, folded, register_slice_compat=compat), jfolded,
           folded, images)


@pytest.mark.parametrize("n_in,n_out", [(180, 640), (320, 1138),
                                        (900, 640), (1600, 1138)])
def test_resize_matrix_matches_jax(n_in, n_out):
    # upsampling (synthetic 180x320) is plain bilinear; downsampling
    # (nuScenes 900x1600) uses jax's antialiased triangle filter
    np.testing.assert_allclose(vit._resize_matrix(n_in, n_out),
                               np.asarray(jvit._resize_matrix(n_in, n_out)),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("src_hw", [(18, 32), (90, 160)])
def test_preprocess_images_matches(rng, src_hw):
    images = rng.integers(0, 256, size=(2, 3) + src_hw + (3,)).astype(
        np.uint8)
    target = (64, 114)
    want = jvit.preprocess_images(jnp.asarray(images), target)
    got = vit.preprocess_images(t(images), target)
    assert got.shape == (2, 3, 64, 114, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    want16 = jvit.preprocess_images(jnp.asarray(images), target,
                                    dtype=jnp.bfloat16)
    got16 = vit.preprocess_images(t(images), target, dtype=torch.bfloat16)
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(want16.astype(jnp.float32)),
                               atol=1e-6, rtol=2.0 ** -7)


def test_rope_angles_match():
    got = vit._rope_angles(40, 71, 64)
    want = jvit._rope_angles(40, 71, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_presets_match_jax():
    for name in ("dinov2_small", "dinov3_small", "dinov3_large"):
        jc, pc = getattr(jvit, name)(), getattr(vit, name)()
        for f in dataclasses.fields(pc):
            if f.name != "dtype":
                assert getattr(pc, f.name) == getattr(jc, f.name), f.name
