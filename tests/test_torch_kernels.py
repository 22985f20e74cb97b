"""The port's attention module vs the JAX package's, on the CPU.

On a CPU tensor ``tpu3dssf_torch.kernels.flash_attention_packed`` runs its
plain PyTorch version (the CUDA kernel is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py). The JAX side runs as the JAX
package's own tests run it here: the Pallas kernel in TPU interpret mode at
one tiny shape, and its jnp references elsewhere.

Tolerance: f32 attention, atol = rtol = 1e-5 — both sides compute in f32
and differ only in summation order and where the softmax scale is applied.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_convert import t
from tpu3dssf.kernels.flash_attention import (flash_attention_packed as
                                              jax_flash_attention_packed,
                                              mha_reference)
from tpu3dssf.kernels.window_attention import (
    window_attention_packed as jax_window_attention_packed,
    window_attention_reference as jax_window_attention_reference)
from tpu3dssf_torch.kernels import (window_attention_packed,
                                    window_attention_reference)
from tpu3dssf_torch.kernels.modules import flash_attention as fa

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


def _packed(rng, B, N, C):
    return rng.normal(size=(B, N, 3 * C)).astype(np.float32)


def _key_mask(rng, W, K, all_masked=None):
    mask = rng.random((W, K)) > 0.3
    if all_masked is not None:
        mask[all_masked] = False
    return mask


def test_plain_matches_pallas_kernel_interpret(rng):
    # one tiny shape: interpret mode is slow on this host
    B, N, C, H = 2, 16, 32, 2
    qkv = _packed(rng, B, N, C)
    bias = np.where(_key_mask(rng, B, N, all_masked=1), 0.0,
                    -1e9).astype(np.float32)[:, None, :]
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash_attention_packed(
            jnp.asarray(qkv), jnp.asarray(bias), H, 16, None, None, 0.25,
            None)
    got = fa.flash_attention_packed(t(qkv), t(bias), H, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("C,H", [(32, 2), (128, 8), (256, 16)])
def test_window_attention_matches_jax_reference(rng, C, H):
    W, K = 3, 24
    D = C // H
    qkv = _packed(rng, W, K, C)
    mask = _key_mask(rng, W, K, all_masked=2)   # one all-padding window
    q, k, v = (jnp.asarray(qkv[..., i * C:(i + 1) * C].reshape(W, K, H, D))
               for i in range(3))
    want = np.asarray(jax_window_attention_reference(
        q, k, v, jnp.asarray(mask))).reshape(W, K, C)
    got = window_attention_packed(t(qkv), t(mask), H)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(got.numpy()[2]).max() == 0.0
    got4 = window_attention_reference(
        *(t(np.asarray(x)) for x in (q, k, v)), t(mask))
    np.testing.assert_allclose(got4.numpy().reshape(W, K, C), want, **TOL)


def test_prescaled_d64_with_key_bias_matches_mha_reference(rng):
    # the ViT call: q pre-scaled by 1/sqrt(D), q_scale None, ragged N
    B, N, C, H = 2, 37, 128, 2
    D = C // H
    q = rng.normal(size=(B, N, H, D)).astype(np.float32)
    k = rng.normal(size=(B, N, H, D)).astype(np.float32)
    v = rng.normal(size=(B, N, H, D)).astype(np.float32)
    bias = (rng.normal(size=(B, 1, N)) * 2).astype(np.float32)
    bias[:, :, -5:] = -1e9
    want = np.asarray(mha_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(bias)))
    packed = np.concatenate([(q / np.sqrt(D)).reshape(B, N, C),
                             k.reshape(B, N, C), v.reshape(B, N, C)], -1)
    got = fa.flash_attention_packed(t(packed), t(bias), H)
    np.testing.assert_allclose(got.numpy(), want.reshape(B, N, C), **TOL)


def test_window_attention_packed_matches_jax_interpret(rng):
    # JAX's inference route for the C=32/64 stages (whole-3C Pallas
    # forward); K=128 is the smallest window its q-blocking accepts
    W, K, C, H = 2, 128, 32, 2
    qkv = _packed(rng, W, K, C)
    mask = _key_mask(rng, W, K, all_masked=1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_window_attention_packed(jnp.asarray(qkv),
                                           jnp.asarray(mask), H)
    got = window_attention_packed(t(qkv), t(mask), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensor_takes_plain_version_without_launching(rng):
    qkv = t(_packed(rng, 2, 40, 64))
    bias = torch.zeros(2, 1, 40)
    before = fa.LAUNCHES
    out = fa.flash_attention_packed(qkv, bias, 4, 0.25)
    window_attention_packed(qkv, torch.ones(2, 40, dtype=torch.bool), 4)
    assert fa.LAUNCHES == before
    torch.testing.assert_close(
        out, fa.flash_attention_packed_reference(qkv, bias, 4, 0.25),
        rtol=0, atol=0)


def test_cuda_wrapper_checks_fail_loudly():
    # the checks a CUDA tensor meets before any launch: the wrappers' on
    # their CUDA kernels' terms (a fake tensor needs no card)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        qkv = torch.empty(1, 8, 96, device="cuda")
        bias = torch.empty(1, 1, 8, device="cuda")
        with pytest.raises(TypeError, match="bfloat16"):
            fa.flash_attention_packed(qkv, bias, 2, None)
        q = torch.empty(1, 8, 4, 8, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim 8 must be one of"):
            fa.flash_attention(q, q, q, bias)
