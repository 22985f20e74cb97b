"""The plain version of the port's k-NN kernel (K7) vs the JAX package.

``topk_neighbors_reference`` (tpu3dssf_torch/voxel/voxelize.py) against
``tpu3dssf.voxel.voxelize._tiled_topk_neighbors`` (its XLA path, tile 64,
so a row of refs spans several tiles) and against ``knn_pallas`` in Pallas
interpret mode. Tolerances: distances at rtol = 1e-5, atol = 1e-4 (the
same f32 formula; JAX's 3-wide dot may round its sum in another order or
fuse a multiply-add); the true distance of every chosen ref equals the JAX
distance within the same tolerance; indices exactly where no two refs are
near-tied (a jittered lattice, or exact duplicates, whose ties both sides
break by the lower index).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_convert import t
from tpu3dssf.kernels.knn import knn_pallas
from tpu3dssf.voxel.voxelize import KNN_BAD_DIST as JAX_BAD
from tpu3dssf.voxel.voxelize import _tiled_topk_neighbors
from tpu3dssf_torch.kernels import knn
from tpu3dssf_torch.voxel.voxelize import (KNN_BAD_DIST, _topk_neighbors,
                                          topk_neighbors_reference)

TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_topk(q, r, m, k, tile=64):
    Q = q.shape[1]
    fn = jax.vmap(lambda a, b, c: _tiled_topk_neighbors(
        a, jnp.ones(Q, bool), b, c, k, tile=tile))
    d, i = fn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m))
    return np.asarray(d), np.asarray(i)


def _true_dist(q, r, idx):
    """f64 squared distance of each chosen ref, (B, Q, k)."""
    chosen = np.take_along_axis(r[:, None, :, :].repeat(q.shape[1], 1),
                                idx[..., None].astype(np.int64), 2)
    return ((q[:, :, None, :].astype(np.float64) - chosen) ** 2).sum(-1)


def _random_cloud(rng, B, Q, R, masked=0.2):
    q = (rng.normal(size=(B, Q, 3)) * 10).astype(np.float32)
    r = (rng.normal(size=(B, R, 3)) * 10).astype(np.float32)
    return q, r, rng.random((B, R)) > masked


def _lattice_cloud(rng, B, Q, R, masked=0.2):
    """Refs on a unit lattice with ±0.2 jitter, queries anywhere in it:
    neighbour distances are far apart compared with f32 rounding."""
    cells = np.stack(np.meshgrid(*(np.arange(8),) * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    r = np.stack([cells[rng.permutation(len(cells))[:R]] for _ in range(B)])
    r = (r + rng.uniform(-0.2, 0.2, size=r.shape)).astype(np.float32)
    q = rng.uniform(0, 7, size=(B, Q, 3)).astype(np.float32)
    return q, r, rng.random((B, R)) > masked


@pytest.mark.parametrize("k", [1, 5, 8])
def test_plain_knn_matches_tiled_topk_at_ragged_shapes(rng, k):
    q, r, m = _random_cloud(rng, 2, 77, 200)
    d, i = topk_neighbors_reference(t(q), t(r), t(m), k)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert tuple(d.shape) == tuple(i.shape) == (2, 77, k)
    want_d, want_i = _jax_topk(q, r, m, k)
    np.testing.assert_allclose(d.numpy(), want_d, **TOL)
    np.testing.assert_allclose(_true_dist(q, r, i.numpy()), want_d, **TOL)
    assert np.take_along_axis(m, i.numpy().reshape(2, -1), 1).all()
    assert (np.diff(d.numpy(), axis=-1) >= 0).all()


@pytest.mark.parametrize("k", [1, 5, 8])
def test_plain_knn_matches_knn_pallas(rng, k):
    q, r, m = _random_cloud(rng, 1, 128, 256)
    d, i = topk_neighbors_reference(t(q), t(r), t(m), k)
    with pltpu.force_tpu_interpret_mode():
        want_d, _ = knn_pallas(jnp.asarray(q[0]), jnp.asarray(r[0]),
                               jnp.asarray(m[0]), k)
    np.testing.assert_allclose(d[0].numpy(), np.asarray(want_d), **TOL)
    np.testing.assert_allclose(_true_dist(q, r, i.numpy())[0],
                               np.asarray(want_d), **TOL)


@pytest.mark.parametrize("k", [1, 5, 8])
def test_plain_knn_indices_equal_on_a_lattice(rng, k):
    q, r, m = _lattice_cloud(rng, 2, 90, 300)
    d, i = topk_neighbors_reference(t(q), t(r), t(m), k)
    want_d, want_i = _jax_topk(q, r, m, k)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_allclose(d.numpy(), want_d, **TOL)


def test_ties_go_to_the_lower_index(rng):
    q, r, m = _lattice_cloud(rng, 1, 40, 100, masked=0.0)
    r[0, 70:] = r[0, 5:35]              # exact duplicates, across tiles
    r[0, 64] = r[0, 3]
    d, i = topk_neighbors_reference(t(q), t(r), t(m), 8)
    want_d, want_i = _jax_topk(q, r, m, 8)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_allclose(d.numpy(), want_d, **TOL)
    dup = np.isin(i.numpy(), np.r_[3, 5:35])
    assert dup.any()


@pytest.mark.parametrize("k", [1, 5])
def test_fewer_than_k_valid_refs_leave_bad_slots_at_index_0(rng, k):
    """The XLA path's fill (KNN_BAD_DIST, index 0); compared with
    ``_tiled_topk_neighbors`` at one tile, where that fill is defined."""
    q, r, _ = _random_cloud(rng, 2, 30, 50)
    m = np.zeros((2, 50), bool)
    m[1, [7, 20, 41]] = True            # sample 0: no valid ref at all
    d, i = topk_neighbors_reference(t(q), t(r), t(m), k)
    want_d, want_i = _jax_topk(q, r, m, k, tile=2048)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_allclose(d.numpy(), want_d, **TOL)
    assert (d[0] == np.float32(JAX_BAD)).all() and (i[0] == 0).all()
    if k == 5:
        assert (d[1, :, 3:] == np.float32(JAX_BAD)).all()
        assert (i[1, :, 3:] == 0).all()
        assert set(i[1, :, :3].flatten().tolist()) <= {7, 20, 41}


def test_chunking_does_not_change_the_result(rng):
    q, r, m = _random_cloud(rng, 2, 77, 200)
    a = topk_neighbors_reference(t(q), t(r), t(m), 5)
    b = topk_neighbors_reference(t(q), t(r), t(m), 5, chunk=300)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version(rng):
    q, r, m = _random_cloud(rng, 1, 10, 20)
    before = knn.LAUNCHES
    d, i = _topk_neighbors(t(q), t(r), t(m), 3)
    ref = topk_neighbors_reference(t(q), t(r), t(m), 3)
    torch.testing.assert_close(d, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(i, ref[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        knn.knn(t(q), t(r), t(m), 3)
    assert knn.LAUNCHES == before
    assert KNN_BAD_DIST == JAX_BAD
