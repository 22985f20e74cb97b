"""The port's fixed-order sums (``serialization.segment_sum``,
``serialization.gather_rows``) where it gathers many rows from one and
where it sums runs of points: PTv3's unpooling gather,
``devoxelize_own_voxel`` and ``voxelize``'s centroid sums, against the
JAX package's functions on the same numpy inputs, forward and gradients
(``jax.vjp``), and two calls of each bit for bit on the CPU.

Tolerances: f32 at atol = rtol = 1e-5, as tests/test_torch_serialization_
voxel.py holds the centroid sums (the same f32 additions in another
order); integer outputs exact; a gather's forward exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_convert import t
from tpu3dssf import voxel as jvox
from tpu3dssf_torch import serialization, voxel

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad(fn, x, up):
    """fn(x), and the gradient of sum(fn(x) · up) in x."""
    x = x.clone().requires_grad_()
    y = fn(x)
    (y * up).sum().backward()
    return y.detach(), x.grad


def test_segment_sum_adds_each_run_and_leaves_out_the_rest(rng):
    seg = np.sort(rng.integers(0, 9, size=(2, 40)), axis=1)
    seg[1, -5:] = 9                            # past the segments: left out
    vals = rng.normal(size=(2, 40, 3)).astype(np.float32)
    got = serialization.segment_sum(t(vals), t(seg).long(), 9)
    want = np.zeros((2, 9, 3), np.float32)
    for b in range(2):
        for i in range(40):
            if seg[b, i] < 9:
                want[b, seg[b, i]] += vals[b, i]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, serialization.segment_sum(t(vals),
                                                      t(seg).long(), 9))


@pytest.mark.parametrize("rows,ordered", [(7, False), (64, False),
                                          (64, True)])
def test_unpooling_gather_matches_jax_and_its_gradient(rng, rows, ordered):
    """The unpooling's gather (``serialization.gather_rows``: many children
    a parent, padding children zeroed and left out of the backward;
    ``ordered``: the parents nondecreasing with the padding last, as the
    pooling numbers them, keys the backward's stable sort leaves in place)
    against JAX's ``take_along_axis`` and ``where``: the forward exact,
    each parent's gradient within 1e-5, two backward passes bit for
    bit."""
    B, N, C = 2, 300, 8
    x = rng.normal(size=(B, rows, C)).astype(np.float32)
    idx = rng.integers(0, rows, size=(B, N))
    valid = rng.random((B, N)) > 0.2
    if ordered:
        idx = np.sort(idx, axis=1)
        valid = np.arange(N)[None, :] < np.array([[260], [300]])
        idx = np.where(valid, idx, rows - 1)       # padding: a clamped row
    up = rng.normal(size=(B, N, C)).astype(np.float32)

    def jfn(v):
        g = jnp.take_along_axis(v, jnp.asarray(idx)[..., None], axis=1)
        return jnp.where(jnp.asarray(valid)[..., None], g, 0.0)

    jy, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(up))

    def fn(v):
        g = serialization.gather_rows(v, t(idx).long(), t(valid))
        return torch.where(t(valid)[..., None], g, 0.0)

    y, g = _grad(fn, t(x), t(up))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    assert torch.equal(g, _grad(fn, t(x), t(up))[1])


def test_devoxelize_own_voxel_matches_jax_and_its_gradient(rng):
    """``devoxelize_own_voxel`` on ``voxelize``'s own assignment (runs of
    up to dozens of points a voxel, dropped points) against JAX's,
    forward and gradient in the voxel values."""
    B, P, V, C = 2, 500, 64, 5
    pts = np.concatenate([rng.normal(size=(B, P, 3)) * 0.6,
                          rng.random((B, P, 1))], -1).astype(np.float32)
    mask = rng.random((B, P)) > 0.1
    vox = voxel.voxelize(t(pts), t(mask), 0.5, V)
    assert int((~vox.point_ok & t(mask)).sum()) > 0      # some dropped
    counts = torch.bincount(vox.point_voxel[0][vox.point_ok[0]])
    assert int(counts.max()) > 8                         # long runs
    vals = rng.normal(size=(B, V, C)).astype(np.float32)
    up = rng.normal(size=(B, P, C)).astype(np.float32)
    pv, ok = vox.point_voxel.numpy(), vox.point_ok.numpy()

    def jfn(v):
        return jax.vmap(jvox.devoxelize_own_voxel)(
            jnp.asarray(pv), jnp.asarray(ok), v)[0]

    jy, vjp = jax.vjp(jfn, jnp.asarray(vals))
    (jg,) = vjp(jnp.asarray(up))

    def fn(v):
        return voxel.devoxelize_own_voxel(vox.point_voxel, vox.point_ok,
                                          v)[0]

    y, g = _grad(fn, t(vals), t(up))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    assert torch.equal(g, _grad(fn, t(vals), t(up))[1])


@pytest.mark.parametrize("capacity", [40, 400])     # 40: voxels dropped
def test_voxelize_sums_match_jax_and_repeat_bit_for_bit(rng, capacity):
    """``voxelize``'s centroids and intensities (fixed-order segment sums
    over the sorted points) against JAX's ``segment_sum`` ones, its
    integer outputs exact, and two calls the same bits."""
    B, P = 2, 600
    pts = np.concatenate([rng.normal(size=(B, P, 3)) * 2.0,
                          rng.random((B, P, 1))], -1).astype(np.float32)
    mask = rng.random((B, P)) > 0.15
    got = voxel.voxelize(t(pts), t(mask), 0.4, capacity)
    want = jax.vmap(lambda p, m: jvox.voxelize(p, m, 0.4, capacity))(
        jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_allclose(got.voxel_raw.numpy(),
                               np.asarray(want.voxel_raw), **TOL)
    for k in ("voxel_coords", "voxel_mask", "num_voxels", "point_voxel",
              "point_ok"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    again = voxel.voxelize(t(pts), t(mask), 0.4, capacity)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
