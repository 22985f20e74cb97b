"""The port's serialization, voxelization and geometry vs the JAX package.

Tolerances: integer outputs (keys, permutations, voxel slots, point_voxel,
patch indices) are compared exactly; f32 geometry and centroid sums at
atol = rtol = 1e-5 (the same f32 operations, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_convert import t
from tpu3dssf import geometry as jgeo
from tpu3dssf import serialization as jser
from tpu3dssf import voxel as jvox
from tpu3dssf_torch import geometry, serialization, voxel

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


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _jax_argsort(hi, lo, valid):
    return np.asarray(jax.vmap(jser.argsort_lex)(hi, lo, valid))


@pytest.mark.parametrize("span", [500, 2048])  # 2048: lo's bit 31 flips
def test_codes_and_sort_order_match_for_every_order(rng, span):
    coords = rng.integers(-span, span, size=(2, 700, 3)).astype(np.int32)
    coords[:, 5] = coords[:, 6]                 # equal keys: stability
    valid = rng.random((2, 700)) > 0.1
    for fn in ("pack_cell_keys", "morton_encode", "hilbert_encode"):
        for a, b in zip(getattr(serialization, fn)(t(coords)),
                        getattr(jser, fn)(jnp.asarray(coords))):
            _eq(a, b)
    for order in serialization.SERIALIZATION_ORDERS:
        hi, lo = serialization.serialization_keys(t(coords), order)
        jhi, jlo = jser.serialization_keys(jnp.asarray(coords), order)
        _eq(hi, jhi)
        _eq(lo, jlo)
        if span == 2048:
            assert (lo < 0).any() and (lo >= 0).any()
        perm = serialization.argsort_lex(hi, lo, t(valid))
        _eq(perm, _jax_argsort(jhi, jlo, jnp.asarray(valid)))
        inv = serialization.inverse_permutation(perm)
        _eq(inv, jax.vmap(jser.inverse_permutation)(jnp.asarray(perm)))


def test_unsigned_bit31_minimal_pair():
    # tests/test_serialization.py::test_serialized_order_is_true_unsigned_
    # order (c): the pair a signed-int32 curve would order backwards
    c2 = np.array([[0, 0, 0], [0, 1024, 0]], np.int32)
    hi, lo = serialization.serialization_keys(t(c2), "z")
    _eq(serialization.argsort_lex(hi, lo), [0, 1])
    _eq(jser.argsort_lex(*jser.serialization_keys(jnp.asarray(c2), "z")),
        [0, 1])


def test_permutation_gather_matches(rng):
    x = rng.normal(size=(2, 9, 4)).astype(np.float32)
    perm = np.stack([rng.permutation(9) for _ in range(2)]).astype(np.int32)
    inv = np.asarray(jax.vmap(jser.inverse_permutation)(jnp.asarray(perm)))
    want = jser.permutation_gather(jnp.asarray(x), jnp.asarray(perm),
                                   jnp.asarray(inv))
    got = serialization.permutation_gather(t(x), t(perm).long(),
                                           t(inv).long())
    _eq(got, want)


def _cloud(rng, B=2, P=600):
    xyz = (rng.normal(size=(B, P, 3)) * 3).astype(np.float32)
    xyz[:, :40] = xyz[:, 40:80] + 0.01           # shared voxels
    inten = rng.random((B, P, 1)).astype(np.float32)
    pts = np.concatenate([xyz, inten], -1)
    mask = np.ones((B, P), bool)
    mask[:, -50:] = False
    return pts, mask


@pytest.mark.parametrize("capacity,mode", [(512, "mean"), (128, "mean"),
                                           (512, "none")])
def test_voxelize_matches_every_field(rng, capacity, mode):
    # capacity 128 < the number of occupied voxels: overflow is dropped
    pts, mask = _cloud(rng)
    got = voxel.voxelize(t(pts), t(mask), 0.5, capacity, mode)
    for b in range(pts.shape[0]):
        want = jvox.voxelize(jnp.asarray(pts[b]), jnp.asarray(mask[b]), 0.5,
                             capacity, mode)
        for name in ("voxel_coords", "voxel_mask", "num_voxels",
                     "point_voxel", "point_ok"):
            _eq(getattr(got, name)[b], getattr(want, name))
        np.testing.assert_allclose(got.voxel_raw[b].numpy(),
                                   np.asarray(want.voxel_raw), **TOL)
    if capacity == 128:
        assert int(got.num_voxels.min()) == 128
        assert not bool(got.point_ok[torch.from_numpy(mask)].all())
    values = rng.normal(size=(2, capacity, 5)).astype(np.float32)
    dv, idx = voxel.devoxelize_own_voxel(got.point_voxel, got.point_ok,
                                         t(values))
    for b in range(2):
        jv, jidx = jvox.devoxelize_own_voxel(
            jnp.asarray(got.point_voxel[b].numpy()),
            jnp.asarray(got.point_ok[b].numpy()), jnp.asarray(values[b]))
        _eq(dv[b], jv)
        _eq(idx[b], jidx)


def _random_quats(rng, *shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_transforms_match(rng):
    ql, tl = _random_quats(rng, 2), rng.normal(size=(2, 3)).astype(np.float32)
    qc = _random_quats(rng, 2, 6)
    tc = rng.normal(size=(2, 6, 3)).astype(np.float32)
    for name, args in (("quaternion_to_rotation_matrix", (qc,)),
                       ("lidar_to_camera_extrinsics", (ql, tl, qc, tc))):
        got = getattr(geometry, name)(*(t(a) for a in args))
        want = getattr(jgeo, name)(*(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    T = np.asarray(jgeo.make_se3(jgeo.quaternion_to_rotation_matrix(qc),
                                 tc))
    np.testing.assert_allclose(geometry.invert_se3(t(T)).numpy(),
                               np.asarray(jgeo.invert_se3(T)), **TOL)


def _cameras(rng, B=2):
    K = np.tile(np.array([[800.0, 0, 800], [0, 800, 450], [0, 0, 1]],
                         np.float32), (B, 6, 1, 1))
    yaw = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    Rt = np.zeros((B, 6, 4, 4), np.float32)
    for c, a in enumerate(yaw):
        # camera looks along (cos a, sin a, 0); z_cam = forward
        f = np.array([np.cos(a), np.sin(a), 0.0])
        r = np.array([np.sin(a), -np.cos(a), 0.0])
        d = np.array([0.0, 0.0, -1.0])
        Rt[:, c, :3, :3] = np.stack([r, d, f])
        Rt[:, c, 3, 3] = 1.0
    Rt[:, :, :3, 3] = rng.normal(size=(B, 6, 3)) * 0.1
    return K, Rt


@pytest.mark.parametrize("sized_by_array", [False, True])
def test_projection_and_patch_index_match(rng, sized_by_array):
    pts = (rng.normal(size=(2, 500, 3)) * 10).astype(np.float32)
    K, Rt = _cameras(rng)
    size = (np.tile(np.array([[900, 1600]], np.float32), (2, 1))
            if sized_by_array else (900, 1600))
    jsize = jnp.asarray(size) if sized_by_array else size
    pix, depth, valid = geometry.multi_camera_projector(
        t(pts), t(K), t(Rt), t(size) if sized_by_array else size)
    jpix, jdepth, jvalid = jgeo.multi_camera_projector(
        jnp.asarray(pts), jnp.asarray(K), jnp.asarray(Rt), jsize)
    _eq(valid, jvalid)
    assert 0.1 < float(valid.float().mean()) < 0.9
    np.testing.assert_allclose(pix.numpy(), np.asarray(jpix), **TOL)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), **TOL)
    spix = geometry.scale_pixel_coords(pix, t(size) if sized_by_array
                                       else size, (640, 1138))
    jspix = jgeo.scale_pixel_coords(jpix, jsize, (640, 1138))
    np.testing.assert_allclose(spix.numpy(), np.asarray(jspix), **TOL)
    _eq(geometry.pixel_to_patch_index(spix, 16, 40, 71),
        jgeo.pixel_to_patch_index(jspix, 16, 40, 71))
