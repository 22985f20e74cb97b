"""The port's weight converter and seeded init, plus helpers shared by the
tests/test_torch_*.py files (JAX configs and parameter trees → the port's).

Every test here feeds seeded numpy inputs through a JAX function and its
counterpart in ``tpu3dssf_torch``; JAX stays on the CPU and data crosses
as numpy arrays.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dssf_torch import convert
from tpu3dssf_torch.models.layers import Dense, LayerNorm, init_weights


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def t(x):
    """numpy / jax array → torch tensor (same dtype)."""
    return torch.from_numpy(np.array(x))


def port_config(jax_cfg, port_cls, **overrides):
    """Copy the fields both dataclasses share (all but ``dtype``, which
    stays the port's float32 default unless overridden)."""
    names = {f.name for f in dataclasses.fields(port_cls)} - {"dtype"}
    kw = {k: getattr(jax_cfg, k) for k in names if hasattr(jax_cfg, k)}
    kw.update(overrides)
    return port_cls(**kw)


def port_pipeline_config(jax_pipe):
    from tpu3dssf_torch.models.fusion import FusionConfig, PipelineConfig
    from tpu3dssf_torch.models.ptv3 import PTv3Config
    return port_config(jax_pipe, PipelineConfig,
                       fusion=port_config(jax_pipe.fusion, FusionConfig),
                       ptv3=port_config(jax_pipe.ptv3, PTv3Config))


def test_dense_and_layernorm_follow_flax(rng):
    x = rng.normal(size=(3, 5, 12)).astype(np.float32)
    dense = nn.Dense(7)
    pd = to_numpy_tree(dense.init(jax.random.PRNGKey(0), x))
    ln = nn.LayerNorm()
    pl = to_numpy_tree(ln.init(jax.random.PRNGKey(1), x))
    pl["params"]["scale"] = rng.normal(size=12).astype(np.float32)
    pl["params"]["bias"] = rng.normal(size=12).astype(np.float32)

    d = Dense(12, 7)
    d.load_state_dict(convert.state_dict_from_flax(pd))
    n = LayerNorm(12)  # flax's default epsilon 1e-6
    n.load_state_dict(convert.state_dict_from_flax(pl))
    # f32 single layer: only summation order differs → 1e-5
    np.testing.assert_allclose(d(t(x)).detach().numpy(),
                               np.asarray(dense.apply(pd, x)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(n(t(x)).detach().numpy(),
                               np.asarray(ln.apply(pl, x)),
                               atol=1e-5, rtol=1e-5)


def test_vit_stacked_and_unrolled_trees_convert_alike():
    from tpu3dssf.models.vit import VisionTransformer, ViTConfig
    from tpu3dssf.train.convert import convert_tree

    cfg = ViTConfig(patch_size=8, image_size=(16, 24), hidden_size=32,
                    num_layers=2, num_heads=2, num_register_tokens=4,
                    use_rope=True, scan_layers=True)
    params = to_numpy_tree(VisionTransformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 24, 3))))
    unrolled = to_numpy_tree(convert_tree(params, to_scan=False))
    assert "block1" in unrolled["params"]
    a = convert.vit_state_dict_from_flax(params, cfg)
    b = convert.vit_state_dict_from_flax(unrolled, cfg)
    assert a.keys() == b.keys()
    assert "blocks.1.qkv.weight" in a and "blocks.0.ls2.gamma" in a
    assert tuple(a["patch_embed.weight"].shape) == (32, 8 * 8 * 3)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_pipeline_converter_refuses_scanned_ptv3():
    """The scan-layout tree that the converter once refused now loads: its
    ``enc3_scan`` stack comes back as one unrolled block per depth row
    (the name is kept from the refusal it replaced)."""
    kernel = np.arange(2 * 4 * 8, dtype=np.float32).reshape(2, 4, 8)
    got = convert.pipeline_state_dict_from_flax(
        {"params": {"ptv3": {"enc3_scan": {"mlp_in": {"kernel": kernel}}},
                    "fusion": {}}})
    assert sorted(got) == ["ptv3.enc3_blk0.mlp_in.weight",
                           "ptv3.enc3_blk1.mlp_in.weight"]
    for i in range(2):
        torch.testing.assert_close(got[f"ptv3.enc3_blk{i}.mlp_in.weight"],
                                   t(kernel[i].T), rtol=0, atol=0)


def _scan_ptv3(**kw):
    """A two-stage JAX PTv3 config (stage depths 2 and 3: both scanned
    under ``scan_blocks``; the decoder's depth-1 stage stays unrolled)."""
    from tpu3dssf.models.ptv3 import PTv3Config
    base = dict(orders=("z", "z-trans"), enc_depths=(2, 3),
                enc_channels=(8, 16), enc_heads=(1, 2), enc_window=(16, 16),
                dec_depths=(1,), dec_channels=(8,), dec_heads=(1,),
                dec_window=(16,), use_pallas=False)
    base.update(kw)
    return PTv3Config(**base)


def _ptv3_tree(scan, seed=0):
    from tpu3dssf.models.ptv3 import PointTransformerV3
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(1, 64, 4)).astype(np.float32)
    cells = rng.choice(16 ** 3, size=(1, 64), replace=False)
    grid = np.stack([cells // 256, (cells // 16) % 16, cells % 16],
                    -1).astype(np.int32)
    model = PointTransformerV3(_scan_ptv3(scan_blocks=scan))
    return to_numpy_tree(jax.jit(model.init)(
        jax.random.PRNGKey(seed), feat, grid, np.ones((1, 64), bool)))


def _leaves_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_convert_tree_round_trips_bit_for_bit():
    from tpu3dssf_torch.train.convert import convert_tree
    for scan in (False, True):
        tree = _ptv3_tree(scan)
        back = convert_tree(convert_tree(tree, not scan), scan)
        _leaves_equal(tree, back)
    assert "enc1_scan" in convert_tree(_ptv3_tree(False), True)["params"]


@pytest.mark.parametrize("to_scan", [True, False])
def test_convert_tree_matches_jax(to_scan):
    """The port's convert_tree against the JAX package's, leaf for leaf,
    on a PTv3 parameter tree and on the AdamW moments that mirror it (an
    optax chain's tuples and namedtuples, as tests/test_convert.py builds
    them), in the direction ``to_scan``."""
    import optax
    from tpu3dssf.train.convert import convert_tree as jax_convert
    from tpu3dssf_torch.train.convert import convert_tree
    params = _ptv3_tree(scan=not to_scan, seed=3)
    moments = jax.tree.map(np.asarray, optax.adamw(1e-3).init(params))
    for tree in (params, moments):
        got = convert_tree(tree, to_scan)
        _leaves_equal(got, jax_convert(tree, to_scan))
    mu = convert_tree(moments, to_scan)[0].mu["params"]
    assert ("enc1_scan" in mu) == to_scan
    assert type(convert_tree(moments, to_scan)[0]) is type(moments[0])


def test_scan_blocks_pipeline_loads_to_the_scanned_logits(rng):
    """A JAX pipeline built with ``scan_blocks=True``: its parameters, in the
    scan layout, load through ``pipeline_state_dict_from_flax`` into the
    port's (unrolled) pipeline, whose logits are the JAX scanned model's
    within 3e-6 (the bound tests/test_convert.py observes between the two
    JAX layouts)."""
    from tests.test_torch_pipeline import _fusion_cfg, _slice_inputs
    from tpu3dssf.models import fusion as jfusion
    from tpu3dssf_torch.models import fusion

    pcfg = jfusion.PipelineConfig(fusion=dataclasses.replace(
                                      _fusion_cfg(), point_feat_dim=8),
                                  ptv3=_scan_ptv3(scan_blocks=True),
                                  voxel_size=0.5, voxel_capacity=64)
    batch, _ = _slice_inputs(rng, P=200)
    tokens = rng.normal(size=(2, 6, 15, 32)).astype(np.float32)
    jpipe = jfusion.SegmentationPipeline(pcfg)
    jargs = [jnp.asarray(batch["points"]), jnp.asarray(batch["point_valid"]),
             jnp.asarray(tokens), jnp.asarray(batch["cam_intrinsics"]),
             jnp.asarray(batch["lidar2cam"])]
    params = to_numpy_tree(jax.jit(jpipe.init)(jax.random.PRNGKey(2),
                                               *jargs))
    assert "enc1_scan" in params["params"]["ptv3"]
    want = np.asarray(jax.jit(jpipe.apply)(params, *jargs))

    model = fusion.SegmentationPipeline(port_pipeline_config(pcfg))
    model.load_state_dict(convert.pipeline_state_dict_from_flax(params))
    with torch.no_grad():
        got = model(*(t(np.asarray(a)) for a in jargs)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-6)


def test_seeded_init_mirrors_flax_initializers():
    from tpu3dssf_torch.models.ptv3 import PTv3Block

    a, b, c = (init_weights(PTv3Block(256, 16, 16, 4.0), seed=s)
               .requires_grad_(False) for s in (3, 3, 4))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    assert not torch.equal(a.mlp_in.weight, c.mlp_in.weight)
    # lecun-normal: std 1/sqrt(fan_in), truncated at 2 of its own sigma
    w = a.mlp_in.weight
    assert abs(float(w.std()) * 256 ** 0.5 - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 / 0.8796 / 256 ** 0.5 + 1e-6
    assert float(a.mlp_in.bias.abs().max()) == 0.0
    assert float((a.norm1.weight - 1).abs().max()) == 0.0
