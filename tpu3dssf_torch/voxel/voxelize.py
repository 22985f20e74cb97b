"""Fixed-capacity voxelization / devoxelization on device, batched.

Port of ``tpu3dssf.voxel.voxelize``. Every function takes a leading batch
dimension written out (the JAX package vmaps a per-sample function):
points (B, P, 4), masks (B, P). Semantics and the :class:`VoxelizeResult`
contract are the JAX package's, including the voxel slot order (cell keys
sorted as signed (hi, lo) int32 pairs) and the overflow rule (voxels past
``capacity`` in that order are dropped and their points flagged).

The segment sums use ``index_add_``; on CUDA that is atomic, so centroid
sums are taken in an order that changes from run to run (integer outputs
do not depend on it).

The k-NN parity modes (``intensity_mode="knn5"``, :func:`devoxelize_nearest`)
find neighbours with :func:`_topk_neighbors`, the op ``tpu3dssf::knn``: a
CUDA tensor launches the hand-written kernel K7
(:mod:`tpu3dssf_torch.kernels.knn`), a CPU tensor takes the plain version
:func:`~tpu3dssf_torch.kernels.knn.topk_neighbors_reference` (importable
from here too).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu3dssf_torch.kernels import knn
from tpu3dssf_torch.kernels.knn import topk_neighbors_reference  # noqa: F401
from tpu3dssf_torch.serialization.codes import pack_cell_keys
from tpu3dssf_torch.serialization.partition import argsort_lex
from tpu3dssf_torch.utils.constants import device_constants

# the reference's 5-NN intensity weights (utils/lidar.py:101)
KNN_INTENSITY_WEIGHTS = (0.4, 0.3, 0.2, 0.05, 0.05)
# distance of a masked ref and of an unfilled k-NN slot: loses to every
# real squared distance and stays finite; never square it (1e30² is inf)
KNN_BAD_DIST = knn.BAD_DIST


class VoxelizeResult(NamedTuple):
    """Outputs of :func:`voxelize` (per batch row, fixed capacity V).

    voxel_raw:    (B, V, 4) centroid xyz + transferred intensity.
    voxel_coords: (B, V, 3) int32 cell coords of each voxel.
    voxel_mask:   (B, V) bool — True for live voxels.
    num_voxels:   (B,) int32 — number of live voxels (≤ V).
    point_voxel:  (B, P) int32 — voxel slot of each input point (V-1-
                  clamped garbage for invalid/overflow points).
    point_ok:     (B, P) bool — point was valid and its voxel fit.
    """

    voxel_raw: torch.Tensor
    voxel_coords: torch.Tensor
    voxel_mask: torch.Tensor
    num_voxels: torch.Tensor
    point_voxel: torch.Tensor
    point_ok: torch.Tensor


def _take(x, idx):
    """x[b, idx[b, i]] for x (B, N, ...) and idx (B, M)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def voxelize(points, point_mask, voxel_size, capacity,
             intensity_mode="mean"):
    """Centroid voxel downsample at fixed capacity.

    Args:
      points: (B, P, 4) float32 [x, y, z, intensity].
      point_mask: (B, P) bool — valid input points.
      voxel_size: python float.
      capacity: python int — max number of voxels V per batch row.
      intensity_mode: "mean" (in-voxel mean), "knn5" (the reference's
        weighted 5-NN transfer from the raw points) or "none".
    """
    if intensity_mode not in ("mean", "knn5", "none"):
        raise ValueError(f"unknown intensity_mode: {intensity_mode!r}")
    B, P, _ = points.shape
    dev = points.device
    xyz = points[..., :3]
    grid = torch.floor(xyz / voxel_size).to(torch.int32)
    hi, lo = pack_cell_keys(grid)
    perm = argsort_lex(hi, lo, point_mask)                     # (B, P)

    hi_s, lo_s = _take(hi, perm), _take(lo, perm)
    valid_s = _take(point_mask, perm)
    new_voxel = torch.ones((B, P), dtype=torch.int32, device=dev)
    new_voxel[:, 1:] = ((hi_s[:, 1:] != hi_s[:, :-1])
                        | (lo_s[:, 1:] != lo_s[:, :-1])).to(torch.int32)
    new_voxel = torch.where(valid_s, new_voxel, 0)
    vid_s = torch.cumsum(new_voxel, dim=1, dtype=torch.int32) - 1
    ok_s = valid_s & (vid_s >= 0) & (vid_s < capacity)
    # dropped points go to a scratch segment `capacity`
    seg = torch.where(ok_s, vid_s, capacity).to(torch.int64)
    flat = (seg + torch.arange(B, device=dev)[:, None] * (capacity + 1))
    flat = flat.reshape(-1)

    pts_s = torch.where(ok_s[..., None], _take(points, perm), 0.0)
    sums = torch.zeros((B * (capacity + 1), 4), dtype=torch.float32,
                       device=dev).index_add_(0, flat, pts_s.reshape(-1, 4))
    counts = torch.zeros(B * (capacity + 1), dtype=torch.float32,
                         device=dev).index_add_(
                             0, flat, ok_s.reshape(-1).to(torch.float32))
    sums = sums.reshape(B, capacity + 1, 4)[:, :capacity]
    counts = counts.reshape(B, capacity + 1)[:, :capacity]

    voxel_mask = counts > 0
    denom = counts.clamp_min(1.0)[..., None]
    centroid = sums[..., :3] / denom
    num_voxels = voxel_mask.sum(dim=1, dtype=torch.int32)

    # sorted voxel ids back to the original point order
    point_voxel = torch.empty((B, P), dtype=torch.int32, device=dev)
    point_voxel.scatter_(1, perm, vid_s.clamp(0, capacity - 1))
    point_ok = torch.empty((B, P), dtype=torch.bool, device=dev)
    point_ok.scatter_(1, perm, ok_s)

    if intensity_mode == "mean":
        intensity = sums[..., 3:4] / denom
    elif intensity_mode == "knn5":
        intensity = knn_intensity_transfer(
            centroid, voxel_mask, xyz, points[..., 3], point_mask)[..., None]
    else:
        intensity = torch.zeros((B, capacity, 1), dtype=torch.float32,
                                device=dev)
    voxel_raw = torch.where(voxel_mask[..., None],
                            torch.cat([centroid, intensity], dim=-1), 0.0)
    # exact cell coords from the first member's grid row (never a
    # re-floored centroid, so voxel_coords stay unique — PTv3's run-max
    # pooling relies on it)
    idx = torch.arange(P, dtype=torch.int64, device=dev).expand(B, P)
    first = torch.full((B, capacity + 1), P, dtype=torch.int64, device=dev)
    first.scatter_reduce_(1, seg, torch.where(ok_s, idx, P), "amin",
                          include_self=True)
    first = first[:, :capacity].clamp(0, P - 1)
    voxel_coords = torch.where(voxel_mask[..., None],
                               _take(_take(grid, perm), first), 0)
    return VoxelizeResult(voxel_raw, voxel_coords, voxel_mask, num_voxels,
                          point_voxel, point_ok)


def devoxelize_own_voxel(point_voxel, point_ok, voxel_values):
    """Per-voxel values (B, V, C) onto points via the recorded voxel
    assignment; returns (point_values (B, P, C), point_voxel)."""
    values = _take(voxel_values, point_voxel.to(torch.int64))
    return torch.where(point_ok[..., None], values, 0.0), point_voxel


def _topk_neighbors(queries, refs, ref_mask, k):
    """The op ``tpu3dssf::knn``: K7 on a CUDA tensor, the plain version on
    a CPU tensor. Like the JAX function, it takes no query mask: every
    query gets neighbours and the callers mask the invalid ones."""
    return torch.ops.tpu3dssf.knn(queries, refs, ref_mask, k)


@device_constants
def _weights(weights, device):
    """``weights`` as an f32 tensor on ``device``, made once (a step holds
    no host-to-device copy, which a CUDA graph could not replay)."""
    with torch.inference_mode(False):
        return torch.tensor(weights, dtype=torch.float32, device=device)


def knn_intensity_transfer(centroids, voxel_mask, points_xyz, intensity,
                           point_mask, weights=KNN_INTENSITY_WEIGHTS):
    """Weighted 5-NN intensity from the raw points onto the centroids (the
    reference's utils/lidar.py:97-105): centroids (B, V, 3), voxel_mask
    (B, V), points_xyz (B, P, 3), intensity (B, P), point_mask (B, P) →
    (B, V), 0 at dead voxels."""
    k = len(weights)
    _, idx = _topk_neighbors(centroids, points_xyz, point_mask, k)
    B, V, _ = idx.shape
    near = torch.gather(intensity, 1, idx.reshape(B, V * k).to(torch.int64))
    w = _weights(tuple(weights), intensity.device)
    return torch.where(voxel_mask, (near.reshape(B, V, k) * w).sum(-1), 0.0)


def devoxelize_nearest(points_xyz, point_mask, centroids, voxel_mask,
                       voxel_values):
    """Per-voxel values (B, V, C) onto points by the nearest live centroid
    (the reference's cdist + argmin, utils/lidar.py:120-172); differentiable
    in ``voxel_values`` through the gather. Returns (point_values
    (B, P, C), nearest voxel (B, P) int32), both 0 at invalid points."""
    _, idx = _topk_neighbors(points_xyz, centroids, voxel_mask, 1)
    idx = idx[..., 0]
    values = _take(voxel_values, idx.to(torch.int64))
    return (torch.where(point_mask[..., None], values, 0.0),
            torch.where(point_mask, idx, 0))
