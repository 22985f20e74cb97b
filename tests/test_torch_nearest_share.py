"""Nearest centroid against own voxel at full width: JAX's XLA search and
the port's, on the CPU.

``devoxelize_mode: nearest`` and ``own`` differ only where a point's
nearest voxel centroid is not the centroid of the voxel it fell into.
This test takes the first frame of ``parity_ab``'s stream (seed 7,
no cache) of ``configs/synthetic_convergence_lidar.yaml`` at its full
width (34,816 points and voxels, voxel 0.10), voxelizes it with the
JAX package's ``voxelize`` and searches with its ``devoxelize_nearest``
(the tiled XLA path with ``Precision.HIGHEST``, what ``knn_pallas`` is
bit-identical to where it runs), and does the same with the port's
``voxelize`` and, on JAX's voxels, its k-NN's plain version. It prints
each side's share of valid points whose nearest centroid is their own
voxel's (run with ``-s`` to read it) and holds:

- the voxelizations equal (the same live voxels, the same centroid under
  every point), except in voxels that hold a point that the jitted JAX
  function puts in the next cell: XLA computes ``xyz / voxel_size`` as
  ``xyz · (1 / voxel_size)`` there, the port divides;
- the port's search on JAX's voxels equal to JAX's at every point, except
  where the two centroids' f64 distances to the point lie within
  ``TIE_TOL`` (relative) of each other: both sides sum
  |q|² − 2 q·r + |r|² in f32 in their own order, which only a near-tie
  can flip;
- JAX's share and the port's on JAX's voxels within the share of the
  points that flipped.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dssf.config import load_config as jload_config
from tpu3dssf.data import HostDataPipeline, SyntheticNuScenes
from tpu3dssf.voxel import devoxelize_nearest as jdevoxelize_nearest
from tpu3dssf.voxel import voxelize as jvoxelize
from tpu3dssf_torch.cli import parity_ab
from tpu3dssf_torch.kernels.knn import topk_neighbors_reference
from tpu3dssf_torch.voxel import voxelize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs/synthetic_convergence_lidar.yaml")
FRAMES = 1
TIE_TOL = 1e-5      # |d²(JAX's) − d²(port's)| over d², in f64, at a flip


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    cfg = jload_config(CONFIG)
    ds = SyntheticNuScenes(
        num_samples=FRAMES, seed=parity_ab.STREAM_SEED,
        num_points=cfg.tpu.synthetic_points,
        image_hw=tuple(cfg.tpu.synthetic_image_hw),
        render_semantics=cfg.tpu.synthetic_render, cache=False)
    batch = next(iter(HostDataPipeline(
        ds, batch_size=FRAMES, point_capacity=cfg.tpu.point_capacity)))
    return cfg, batch["points"], batch["point_valid"]


def _search(points, centroids, mask):
    """The port's nearest centroid (its k-NN's plain version) per point."""
    return topk_neighbors_reference(
        points[..., :3].contiguous(), centroids.contiguous(), mask,
        1)[1][0, :, 0].numpy()


def test_nearest_is_own_share_matches_jax_at_full_width(frames):
    cfg, points, valid = frames
    cap, size = cfg.tpu.voxel_capacity, cfg.voxel_size

    @jax.jit
    def jax_side(p, m):
        vox = jvoxelize(p, m, size, cap, intensity_mode="none")
        _, nearest = jdevoxelize_nearest(
            p[:, :3], m, vox.voxel_raw[:, :3], vox.voxel_mask,
            jnp.zeros((cap, 1), jnp.float32))
        return (vox.voxel_raw[:, :3], vox.voxel_mask, vox.point_voxel,
                vox.point_ok & m, nearest)

    shares = {"jax": [], "port on JAX's voxels": []}
    for i in range(FRAMES):
        cent, vmask, own, ok, j_near = map(np.asarray, jax_side(
            jnp.asarray(points[i]), jnp.asarray(valid[i])))
        p = torch.as_tensor(points[i:i + 1])
        m = torch.as_tensor(valid[i:i + 1])
        vox = voxelize(p, m, size, cap, intensity_mode="none")
        t_own = vox.point_voxel[0].numpy()
        t_ok = (vox.point_ok & m)[0].numpy()
        np.testing.assert_array_equal(t_ok, ok)
        np.testing.assert_array_equal(vox.voxel_mask[0].numpy(), vmask)
        # the voxelizations: the same centroid under every point but those
        # whose voxel holds a point that the jitted x · (1 / size) puts in
        # another cell than x / size does (the voxel slots after such a
        # cell may shift by one, so the points' centroids are compared)
        xyz = points[i, :, :3]
        edge = ok & (np.floor(xyz * np.float32(1 / size))
                     != np.floor(xyz / np.float32(size))).any(-1)
        t_cent = vox.voxel_raw[0, :, :3].numpy()
        kept = (ok & ~np.isin(own, own[edge])
                & ~np.isin(t_own, t_own[edge]))
        np.testing.assert_allclose(t_cent[t_own[kept]], cent[own[kept]],
                                   rtol=0, atol=1e-6)
        assert kept.sum() > ok.sum() // 2          # not vacuous

        # the search alone, on JAX's voxels: equal but at near-ties
        t_near = _search(p, torch.tensor(cent)[None],
                         torch.tensor(vmask)[None])
        flips = np.flatnonzero(ok & (t_near != j_near))
        q = xyz[flips].astype(np.float64)
        c = cent.astype(np.float64)
        d_j = ((q - c[j_near[flips]]) ** 2).sum(-1)
        d_t = ((q - c[t_near[flips]]) ** 2).sum(-1)
        assert np.all(np.abs(d_j - d_t) <= TIE_TOL * np.maximum(d_j, d_t)), \
            (flips, d_j, d_t)

        shares["jax"].append(float((j_near == own)[ok].mean()))
        shares["port on JAX's voxels"].append(
            float((t_near == own)[ok].mean()))
        assert abs(shares["jax"][-1] - shares["port on JAX's voxels"][-1]) \
            <= len(flips) / ok.sum()
    print(f"nearest centroid == own voxel, per frame (voxel {size}, "
          f"capacity {cap}): {shares}")
