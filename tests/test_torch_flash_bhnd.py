"""The port's (B, N, H, D) and (W, K, H, D) attention (K8, K9, K6 and the
window route's K4/K5) vs the JAX package's, on the CPU.

On CPU tensors ``flash_attention`` and ``window_attention``, and their
shared training rule ``FlashAttention``, run the plain versions of the
kernels (the CUDA kernels are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py). The JAX side runs as the JAX
package's own tests run it here: the Pallas kernels (``_flash_kernel``,
``_flash_bwd_kernel``, ``_attn_kernel``, ``_attn_kernel_lse``,
``_attn_bwd_kernel``) in TPU interpret mode at tiny shapes, and the jnp
references with their autodiff VJPs.

Tolerance: f32 atol = rtol = 1e-5 for outputs and gradients — both sides
compute in f32 and differ only in summation order and in where the softmax
is normalised.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_convert import t
from tpu3dssf_torch import kernels

# the modules (tpu3dssf_torch.kernels and tpu3dssf.kernels re-export
# functions of the same names)
from tpu3dssf_torch.kernels.modules import flash_attention as fa
from tpu3dssf_torch.kernels.modules import window_attention as wa
jfa = importlib.import_module("tpu3dssf.kernels.flash_attention")
jwa = importlib.import_module("tpu3dssf.kernels.window_attention")
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


def _counts():
    return (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.BWD_LAUNCHES, fa.FLASH_LAUNCHES,
            fa.FLASH_BWD_LAUNCHES, wa.LAUNCHES, wa.LSE_LAUNCHES,
            wa.BWD_LAUNCHES)


def _bhnd(rng, B, N, H, D, n=4):
    return [rng.normal(size=(B, N, H, D)).astype(np.float32)
            for _ in range(n)]


def _trailing_bias(B, N, masked=5):
    """JAX test_attention.py's key bias: the last ``masked`` keys at −1e9."""
    bias = np.zeros((B, 1, N), np.float32)
    bias[:, :, N - masked:] = -1e9
    return bias


def _torch_vjp(fn, inputs, g):
    xs = [t(x).requires_grad_() for x in inputs]
    out = fn(*xs)
    out.backward(t(g))
    return out.detach(), [x.grad for x in xs]


@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_and_its_vjp_match_jax_interpret(rng, masked):
    """K8 forward and the K9 rule vs JAX's ``flash_attention`` custom VJP
    (Pallas interpret mode; N = 24 is ragged against block_q = 16), with
    and without a bias masking trailing keys."""
    B, N, H, D = 1, 24, 2, 8
    q, k, v, g = _bhnd(rng, B, N, H, D)
    bias = _trailing_bias(B, N) if masked else None
    jbias = None if bias is None else jnp.asarray(bias)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
            a, b, c, 16, jbias), *map(jnp.asarray, (q, k, v)))
        want_d = vjp(jnp.asarray(g))
    tb = None if bias is None else t(bias)
    before = _counts()
    with torch.no_grad():
        got = fa.flash_attention(t(q), t(k), t(v), tb)
    out, d = _torch_vjp(lambda a, b, c: fa.flash_attention(a, b, c, tb),
                        (q, k, v), g)
    assert _counts() == before                  # CPU: plain versions only
    assert out.grad_fn is None and type(got) is torch.Tensor
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    for a, b in zip(d, want_d):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("N,bias_heads", [(24, 1), (37, 1), (37, 2)])
def test_mha_reference_matches_jax(rng, N, bias_heads):
    B, H, D = 2, 2, 16
    q, k, v = _bhnd(rng, B, N, H, D, 3)
    bias = rng.normal(size=(B, bias_heads, N)).astype(np.float32)
    want = jfa.mha_reference(*map(jnp.asarray, (q, k, v, bias)))
    got = kernels.mha_reference(t(q), t(k), t(v), t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        kernels.mha_reference(t(q), t(k), t(v)).numpy(),
        np.asarray(jfa.mha_reference(*map(jnp.asarray, (q, k, v)))), **TOL)


@pytest.mark.parametrize("N", [16, 40])
def test_k9_plain_version_matches_the_tpu_kernel(rng, N):
    """K9's plain version, fed the forward's LSE and delta, vs the TPU
    kernel ``_flash_bwd_call`` (interpret mode), which rebuilds p from a
    full-row max and sum: the same gradient."""
    B, H, D = 1, 2, 8
    q, k, v, g = _bhnd(rng, B, N, H, D)
    bias = _trailing_bias(B, N)
    scale = 1.0 / D ** 0.5
    out, lse = fa.flash_attention_lse_reference(t(q), t(k), t(v), t(bias),
                                                scale)
    delta = fa.row_delta(t(g), out)
    got = fa.flash_attention_bwd_reference(t(q), t(k), t(v), t(bias), t(g),
                                           lse, delta, scale)

    def bhnd(x):
        return jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))

    with pltpu.force_tpu_interpret_mode():
        dqs, dk, dv = jfa._flash_bwd_call(
            bhnd(q) * jnp.float32(scale), bhnd(k), bhnd(v), jnp.asarray(bias),
            bhnd(g), 8)
    for a, b in zip(got, (dqs * jnp.float32(scale), dk, dv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(bhnd(b)), **TOL)


def _windows(rng, W, K, H, D, all_masked=None):
    q, k, v, g = _bhnd(rng, W, K, H, D)
    mask = rng.random((W, K)) > 0.3
    if all_masked is not None:
        mask[all_masked] = False                 # one all-padding window
    return q, k, v, g, mask


def test_window_attention_matches_pallas_interpret(rng):
    """K6 forward and the K4/K5 rule vs JAX's ``window_attention(...,
    True)`` (Pallas interpret mode; tiny, as the JAX package's own test)."""
    q, k, v, g, mask = _windows(rng, 1, 8, 1, 8)
    jin = [jnp.asarray(x) for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        want = jwa.window_attention(*jin, jnp.asarray(mask), True)
        _, vjp = jax.vjp(lambda a, b, c: jwa.window_attention(
            a, b, c, jnp.asarray(mask), True), *jin)
        want_d = vjp(jnp.asarray(g))
    before = _counts()
    with torch.no_grad():
        got = kernels.window_attention(t(q), t(k), t(v), t(mask))
    out, d = _torch_vjp(lambda a, b, c: kernels.window_attention(
        a, b, c, t(mask)), (q, k, v), g)
    assert _counts() == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    for a, b in zip(d, want_d):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_window_attention_vjp_matches_the_jnp_vjp(rng):
    """The K4/K5 rule vs JAX's jnp path (``window_attention(..., False)``:
    autodiff of the reference); g is random on every row (the rule masks
    it), window 2 is all padding."""
    q, k, v, g, mask = _windows(rng, 3, 32, 2, 16, all_masked=2)
    jin = [jnp.asarray(x) for x in (q, k, v)]
    want, vjp = jax.vjp(lambda a, b, c: jwa.window_attention(
        a, b, c, jnp.asarray(mask), False), *jin)
    want_d = vjp(jnp.asarray(g))
    out, d = _torch_vjp(lambda a, b, c: kernels.window_attention(
        a, b, c, t(mask)), (q, k, v), g)
    y = kernels.window_attention(t(q).requires_grad_(), t(k), t(v), t(mask))
    assert type(y.grad_fn).__name__ == "FlashAttentionBackward"
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    for a, b in zip(d, want_d):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        assert a[2].abs().max().item() == 0.0    # all-padding window
    assert d[0][torch.from_numpy(~mask)].abs().max().item() == 0.0


def test_window_attention_takes_strided_views_of_the_projection(rng):
    """PTv3 hands the (W, K, H, D) route q/k/v views of its (W, K, 3C)
    projection: the result is the reference's on copies."""
    W, K, H, D = 2, 48, 4, 16
    qkv = t(rng.normal(size=(W, K, 3 * H * D)).astype(np.float32))
    mask = t(rng.random((W, K)) > 0.2)
    q, k, v = qkv.unflatten(-1, (3, H, D)).unbind(2)
    assert not q.is_contiguous()
    with torch.no_grad():
        got = kernels.window_attention(q, k, v, mask)
    want = kernels.window_attention_reference(q.contiguous(), k.contiguous(),
                                              v.contiguous(), mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("heads,channels", [
    (16, 1024), (16, 256), (16, 128), (32, 512), (12, 768), (6, 384),
    (2, 32), (10, 160)])
def test_pick_head_group_matches_jax(heads, channels):
    assert (kernels.pick_head_group(heads, channels)
            == jfa.pick_head_group(heads, channels))


def test_packed_plain_versions_are_the_strided_ones(rng):
    """The packed references are the (B, N, H, D) ones on views of qkv."""
    B, N, H, D = 2, 20, 2, 16
    C = H * D
    qkv = t(rng.normal(size=(B, N, 3 * C)).astype(np.float32))
    bias = t(_trailing_bias(B, N))
    g = t(rng.normal(size=(B, N, C)).astype(np.float32))
    out, lse = fa.flash_attention_packed_lse_reference(qkv, bias, H, 0.25)
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, H, D)
               for i in range(3))
    out4, lse4 = fa.flash_attention_lse_reference(q, k, v, bias, 0.25)
    np.testing.assert_array_equal(out.numpy(), out4.reshape(B, N, C).numpy())
    np.testing.assert_array_equal(lse.numpy(), lse4.numpy())
    delta = fa.row_delta(g, out, H)
    np.testing.assert_array_equal(delta.numpy(), fa.row_delta(
        g.reshape(B, N, H, D), out4).numpy())
    dqkv = fa.flash_attention_packed_bwd_reference(qkv, bias, g, lse, delta,
                                                   H, 0.25)
    grads = fa.flash_attention_bwd_reference(q, k, v, bias,
                                             g.reshape(B, N, H, D), lse4,
                                             delta, 0.25)
    np.testing.assert_array_equal(
        dqkv.numpy(), torch.cat([x.reshape(B, N, C) for x in grads],
                                -1).numpy())
