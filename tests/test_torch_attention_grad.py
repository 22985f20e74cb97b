"""The port's attention training rules and their plain versions vs the
JAX package's custom VJPs, on the CPU.

On CPU tensors ``FlashAttentionPacked`` and ``WindowAttentionPacked`` run
the plain versions of the forward-with-LSE and backward kernels (the CUDA
kernels are checked on the card by tests/test_torch_cuda.py and
chip_smoke.py). The JAX side runs as the JAX package's own tests run it
here: the Pallas kernels (K2/K3 ``_packed_fwd_call(with_lse=True)`` and
``_packed_bwd_call``, K4/K5 ``_wap_fwd``/``_wap_bwd``) in TPU interpret
mode, one tiny shape each.

Tolerance: f32 atol = rtol = 1e-5 for outputs, LSE and gradients — both
sides compute in f32 and differ only in summation order. LSE rows of an
all-padding window sit at −1e9, where rtol admits their f32 ulp of 64.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_convert import t
from tpu3dssf.serialization.partition import (
    permutation_gather as jax_permutation_gather)
from tpu3dssf_torch.serialization import permutation_gather

# the modules (tpu3dssf_torch.kernels and tpu3dssf.kernels re-export
# functions of the same names)
from tpu3dssf_torch.kernels.modules import flash_attention as fa
from tpu3dssf_torch.kernels.modules import window_attention as wa
jfa = importlib.import_module("tpu3dssf.kernels.flash_attention")
jwa = importlib.import_module("tpu3dssf.kernels.window_attention")
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(rng, B, N, C, all_masked=1):
    qkv = rng.normal(size=(B, N, 3 * C)).astype(np.float32)
    mask = rng.random((B, N)) > 0.3
    mask[all_masked] = False                 # one all-padding window
    bias = np.where(mask, 0.0, -1e9).astype(np.float32)[:, None, :]
    g = rng.normal(size=(B, N, C)).astype(np.float32)
    return qkv, mask, bias, g


def test_lse_plain_version_matches_pallas_interpret(rng):
    B, N, C, H = 2, 16, 32, 2
    qkv, _, bias, _ = _inputs(rng, B, N, C)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = jfa._packed_fwd_call(
            jnp.asarray(qkv), jnp.asarray(bias), H, N, None, None, 0.25,
            None, with_lse=True)
    got, lse = fa.flash_attention_packed_lse_reference(t(qkv), t(bias), H,
                                                       0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


def test_backward_plain_version_matches_pallas_interpret(rng):
    B, N, C, H = 2, 16, 32, 2
    qkv, mask, bias, g = _inputs(rng, B, N, C)
    g = g * mask[..., None]
    out, lse = fa.flash_attention_packed_lse_reference(t(qkv), t(bias), H,
                                                       0.25)
    delta = fa.row_delta(t(g), out, H)
    with pltpu.force_tpu_interpret_mode():
        want = jfa._packed_bwd_call(
            jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(g), H, N, 0.25,
            None, lse=jnp.asarray(lse.numpy()),
            delta=jnp.asarray(delta.numpy()))
    got = fa.flash_attention_packed_bwd_reference(t(qkv), t(bias), t(g), lse,
                                                  delta, H, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.abs(got.numpy()[1]).max() == 0.0   # all-padding window


def _torch_vjp(fn, qkv, g):
    x = t(qkv).requires_grad_()
    out = fn(x)
    out.backward(t(g))
    return out.detach(), x.grad


def test_flash_attention_packed_grads_match_jax_vjp(rng):
    """K2 + K3 rule vs JAX's custom VJP (interpret) and vs torch autograd
    of the plain forward; g is zero on masked queries, as the PTv3 caller
    makes it."""
    B, N, C, H = 2, 16, 32, 2
    qkv, mask, bias, g = _inputs(rng, B, N, C)
    g = g * mask[..., None]
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda p: jfa.flash_attention_packed(
            p, jnp.asarray(bias), H, N, None, None, 0.25, None),
            jnp.asarray(qkv))
        (want_d,) = vjp(jnp.asarray(g))
    before = (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.BWD_LAUNCHES)
    out, d = _torch_vjp(lambda x: fa.flash_attention_packed(x, t(bias), H,
                                                            0.25), qkv, g)
    assert (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.BWD_LAUNCHES) == before
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), **TOL)
    _, d_auto = _torch_vjp(lambda x: fa.flash_attention_packed_reference(
        x, t(bias), H, 0.25), qkv, g)
    np.testing.assert_allclose(d.numpy(), d_auto.numpy(), **TOL)
    assert d.abs()[1].max().item() == 0.0        # all-padding window


def test_window_attention_packed_grads_match_jax_vjp(rng):
    """K4 + K5 rule vs JAX's custom VJP (interpret) and vs torch autograd
    of ``window_attention_reference``; g is random on every row (the rule
    masks it)."""
    W, K, C, H = 3, 16, 32, 2
    D = C // H
    qkv, mask, _, g = _inputs(rng, W, K, C, all_masked=2)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda p: jwa.window_attention_packed(
            p, jnp.asarray(mask), H), jnp.asarray(qkv))
        (want_d,) = vjp(jnp.asarray(g))
    before = (wa.LSE_LAUNCHES, wa.BWD_LAUNCHES)
    out, d = _torch_vjp(lambda x: wa.window_attention_packed(x, t(mask), H),
                        qkv, g)
    assert (wa.LSE_LAUNCHES, wa.BWD_LAUNCHES) == before
    assert type(out) is torch.Tensor
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), **TOL)

    def ref(x):
        q, k, v = (x[..., i * C:(i + 1) * C].reshape(W, K, H, D)
                   for i in range(3))
        return wa.window_attention_reference(q, k, v, t(mask)).reshape(
            W, K, C)

    _, d_auto = _torch_vjp(ref, qkv, g)
    np.testing.assert_allclose(d.numpy(), d_auto.numpy(), **TOL)
    assert d.abs()[2].max().item() == 0.0        # all-padding window
    assert d.abs()[torch.from_numpy(~mask)].max().item() == 0.0


def _graph(fn, seen=None):
    """Names of the autograd nodes reachable from ``fn``."""
    seen = set() if seen is None else seen
    if fn is not None and fn not in seen:
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            _graph(nxt, seen)
    return {type(f).__name__ for f in seen}


RULES = ("FlashAttentionPacked", "WindowAttentionPacked", "FlashAttention")


@pytest.mark.parametrize("C,H,window,rule", [
    (32, 2, 128, "WindowAttentionPacked"),
    (128, 8, 128, "FlashAttentionPacked"),
    (32, 2, 16, "FlashAttention"),         # K % 128 != 0
    (128, 16, 128, "FlashAttention")])     # no 128-aligned head group
def test_serialized_attention_takes_the_jax_route(rng, C, H, window, rule):
    """At a window K % 128 == 0: C % 128 == 0 → the packed rule, else the
    packed window rule; any other K, or more than 8 heads without a
    128-aligned head group → the (W, K, H, D) rule (FlashAttention with a
    query mask). Without a gradient each gives the same output from its
    inference forward."""
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.ptv3 import SerializedAttention

    N = max(window, 32)
    attn = init_weights(SerializedAttention(C, H, window), 0)
    x = t(rng.normal(size=(2, N, C)).astype(np.float32))
    mask = t(rng.random((2, N)) > 0.2)
    y = attn(x, None, None, mask)
    names = _graph(y.grad_fn)
    assert {r for r in RULES if r + "Backward" in names} == {rule}
    with torch.no_grad():
        np.testing.assert_allclose(y.detach().numpy(),
                                   attn(x, None, None, mask).numpy(), **TOL)


def test_permutation_gather_grads_match_jax(rng):
    B, N, C = 2, 24, 5
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    perm = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
    inv = np.argsort(perm, axis=1).astype(np.int32)
    g = rng.normal(size=(B, N, C)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_permutation_gather(
        a, jnp.asarray(perm), jnp.asarray(inv)), jnp.asarray(x))
    (want_d,) = vjp(jnp.asarray(g))
    xt = t(x).requires_grad_()
    out = permutation_gather(xt, t(perm).long(), t(inv).long())
    assert "PermutationGather" in type(out.grad_fn).__name__
    out.backward(t(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_d))
