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
    with pytest.raises(ValueError, match="scan_blocks"):
        convert.pipeline_state_dict_from_flax(
            {"params": {"ptv3": {"enc3_scan": {}}, "fusion": {}}})


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
