"""K1's RoPE branch in the port vs the JAX package's, on the CPU.

On CPU tensors ``flash_attention_packed`` with ``rope_cos``/``rope_sin``
runs its plain version, and its training rule ``FlashAttentionPacked``
the plain versions of the forward with LSE and of K9 around the rotation
(the CUDA kernels are checked on the card by tests/test_torch_cuda.py and
chip_smoke.py). The JAX side runs ``flash_attention_packed(..., cos, sin,
q_scale)`` and its custom VJP as tests/test_attention.py does: the Pallas
kernel in TPU interpret mode.

* Forward and gradient at JAX's own shape (B 2, N 32, H 2, D 8, 3 identity
  prefix rows, 6 masked tail keys) at q_scale 1/√8 (D's own) and 1/8, and a
  forward at D = 64 (B 1, N 40, H 2).
* Where q·q_scale is rounded: once, after the rotation in f32 with the f32
  scale (the RoPE-free branch multiplies by q_scale rounded to q's dtype).
* The ViT's routes, port vs JAX, with both sides' kernel entry points
  replaced by recorders: the K1 route hands the kernel the projection's own
  qkv and the tables; the K8 route rotates q and k outside.

Tolerance: f32 atol = rtol = 1e-5 (both sides compute in f32 and differ
only in summation order); the rounding test is exact.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_convert import port_config, t
from tpu3dssf.models import vit as jvit
from tpu3dssf_torch.kernels.modules import flash_attention as fa
from tpu3dssf_torch.models import vit

jfa = importlib.import_module("tpu3dssf.kernels.flash_attention")
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, B, N, H, D, n_pre=3, n_masked=6):
    """qkv (B, N, 3C), a bias masking the last ``n_masked`` keys, an
    upstream gradient, and (N, D/2) tables with identity rows for the
    ``n_pre`` prefix tokens and the masked tail (JAX's test)."""
    C, D2 = H * D, D // 2
    qkv = rng.normal(size=(B, N, 3 * C)).astype(np.float32)
    bias = np.zeros((B, 1, N), np.float32)
    bias[:, :, N - n_masked:] = -1e9
    g = rng.normal(size=(B, N, C)).astype(np.float32)
    angles = rng.uniform(-3, 3, size=(N - n_pre - n_masked, D2))
    cos = np.concatenate([np.ones((n_pre, D2)), np.cos(angles),
                          np.ones((n_masked, D2))]).astype(np.float32)
    sin = np.concatenate([np.zeros((n_pre, D2)), np.sin(angles),
                          np.zeros((n_masked, D2))]).astype(np.float32)
    return qkv, bias, g, cos, sin


@pytest.mark.parametrize("q_scale", [1 / math.sqrt(8), 0.125])
def test_rope_branch_and_its_gradient_match_jax(rng, q_scale):
    B, N, H, D = 2, 32, 2, 8
    qkv, bias, g, cos, sin = _inputs(rng, B, N, H, D)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda p: jfa.flash_attention_packed(
            p, jnp.asarray(bias), H, 16, jnp.asarray(cos), jnp.asarray(sin),
            q_scale), jnp.asarray(qkv))
        (want_dqkv,) = vjp(jnp.asarray(g))
    x = t(qkv).requires_grad_()
    counts = (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.FLASH_BWD_LAUNCHES)
    out = fa.flash_attention_packed(x, t(bias), H, q_scale, t(cos), t(sin))
    out.backward(t(g))
    assert (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.FLASH_BWD_LAUNCHES) == counts
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dqkv), **TOL)
    with torch.no_grad():   # the inference entry: the same plain forward
        plain = fa.flash_attention_packed(t(qkv), t(bias), H, q_scale,
                                          t(cos), t(sin))
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)


def test_rope_branch_at_head_dim_64_matches_jax(rng):
    B, N, H, D = 1, 40, 2, 64
    qkv, bias, _, cos, sin = _inputs(rng, B, N, H, D, n_pre=5, n_masked=4)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention_packed(
            jnp.asarray(qkv), jnp.asarray(bias), H, 8, jnp.asarray(cos),
            jnp.asarray(sin), 0.125)
    got = fa.flash_attention_packed_reference(t(qkv), t(bias), H, 0.125,
                                              t(cos), t(sin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_rounds_q_times_the_f32_scale_once(rng):
    """In bf16: q is rotated as x·q_scale in f32 (the f32 value of the
    scale), each product and sum rounded in f32, then rounded to bf16 once;
    not by bf16(q_scale), which the RoPE-free branch multiplies by."""
    N, H, D = 40, 2, 64
    _, _, _, cos, sin = _inputs(rng, 1, N, H, D, n_pre=5, n_masked=0)
    q = t(rng.normal(size=(1, N, H, D)).astype(np.float32)).to(
        torch.bfloat16)
    got = fa.rope_rotate(q, t(cos), t(sin), 1 / math.sqrt(8))

    def by_hand(scale):
        x = q.float().numpy() * np.float32(scale)
        x1, x2 = x[..., :D // 2], x[..., D // 2:]
        c, s = cos[:, None, :], sin[:, None, :]
        rot = np.concatenate([x1 * c - x2 * s, x1 * s + x2 * c], -1)
        return torch.from_numpy(rot).to(torch.bfloat16)

    assert torch.equal(got, by_hand(1 / math.sqrt(8)))
    bf16_scale = float(torch.tensor(1 / math.sqrt(8), dtype=torch.bfloat16))
    assert not torch.equal(got, by_hand(bf16_scale))
    # the identity prefix rows pass q·scale through
    assert torch.equal(got[:, :5], (q[:, :5].float() * np.float32(
        1 / math.sqrt(8))).to(torch.bfloat16))


def _recorder(calls, shape_of):
    def record(*args, **kwargs):
        calls.append(args)
        return shape_of(*args)
    return record


@pytest.mark.parametrize("H,C,packed_head_groups,route", [
    (6, 384, True, "packed"), (16, 1024, True, "packed"),
    (16, 1024, False, "bhnd")])
def test_vit_routes_take_the_rope_branch(monkeypatch, H, C,
                                         packed_head_groups, route):
    """The K1 route passes the projection's own qkv (same storage, no
    repacking), q_scale 1/√D and the tables; the K8 route passes q and k
    rotated outside by the same tables and v as a view of the projection.
    JAX's ViT takes the same route (it rotates outside on both)."""
    cfg = jvit.ViTConfig(hidden_size=C, num_heads=H, num_layers=1,
                         patch_size=8, image_size=(24, 40),
                         num_register_tokens=4, use_rope=True, use_flash=True,
                         packed_head_groups=packed_head_groups)
    N, D = cfg.num_prefix_tokens + cfg.num_patches, C // H
    x = np.asarray(np.random.default_rng(1).normal(size=(1, N, C)),
                   np.float32)
    jax_calls, port_calls = {}, {}
    for name, shape_of in (
            ("flash_attention_packed",
             lambda qkv, *_: qkv.shape[:-1] + (qkv.shape[-1] // 3,)),
            ("flash_attention", lambda q, *_: q.shape)):
        monkeypatch.setattr(jfa, name, _recorder(
            jax_calls.setdefault(name, []),
            lambda *a, s=shape_of: jnp.zeros(s(*a), a[0].dtype)))
        monkeypatch.setattr(vit, name, _recorder(
            port_calls.setdefault(name, []),
            lambda *a, s=shape_of: torch.zeros(s(*a), dtype=a[0].dtype)))
    block = jvit.ViTBlock(cfg)
    angles = jvit._rope_angles(*cfg.grid_size, D)
    params = block.init(jax.random.PRNGKey(0), x, angles)
    for calls in jax_calls.values():
        del calls[:]
    block.apply(params, x, angles)

    pcfg = port_config(cfg, vit.ViTConfig)
    port = vit.ViTBlock(pcfg)
    seen = []
    port.qkv.register_forward_hook(lambda m, i, o: seen.append(o))
    cos, sin = vit.rope_tables(pcfg)
    with torch.no_grad():
        port(t(x), (cos, sin), torch.zeros(1, 1, N))
    name = "flash_attention_packed" if route == "packed" else \
        "flash_attention"
    assert {k: len(v) for k, v in port_calls.items() if v} == {name: 1}
    assert {k: len(v) for k, v in jax_calls.items() if v} == {name: 1}
    (args,), (qkv,) = port_calls[name], seen
    if route == "packed":
        assert args[0] is qkv and args[2] == H
        assert args[3] == pytest.approx(1 / math.sqrt(D), rel=1e-15)
        assert args[4] is cos and args[5] is sin
        jargs = jax_calls[name][0]   # JAX rotated beforehand: no tables
        assert len(jargs) < 5 or jargs[4] is None
    else:
        q, k, v = (y.unflatten(-1, (H, D)) for y in qkv.split(C, dim=-1))
        assert torch.equal(args[0], fa.rope_rotate(q, cos, sin))
        assert torch.equal(args[1], fa.rope_rotate(k, cos, sin))
        assert args[2].data_ptr() == v.data_ptr()
        assert args[2].untyped_storage().data_ptr() == \
            qkv.untyped_storage().data_ptr()


def test_rope_tables_rotate_as_jax_apply_rope(rng):
    """The ViT's tables (identity prefix rows) rotate q as JAX's
    ``_apply_rope`` does from the angles (prefix passed through)."""
    cfg = vit.dinov3_small()
    gh, gw = 4, 6
    cfg = vit.ViTConfig(**{**cfg.__dict__, "image_size": (gh * 16, gw * 16)})
    N = cfg.num_prefix_tokens + gh * gw
    x = rng.normal(size=(2, N, 6, 64)).astype(np.float32)
    cos, sin = vit.rope_tables(cfg)
    assert cos.shape == sin.shape == (N, 32)
    assert bool((cos[:5] == 1).all()) and bool((sin[:5] == 0).all())
    want = jvit._apply_rope(jnp.asarray(x), jvit._rope_angles(gh, gw, 64),
                            cfg.num_prefix_tokens)
    np.testing.assert_allclose(fa.rope_rotate(t(x), cos, sin).numpy(),
                               np.asarray(want), **TOL)
