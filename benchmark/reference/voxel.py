"""Voxelization, devoxelization and the k-nearest-neighbour search of the
reference, batched over a leading dimension.

Semantics of the configurations: voxels are cells of ``voxel_size`` in the
LiDAR frame, ordered by their cell key (x, then y and z packed) and kept up
to ``capacity``; a voxel holds the mean of its points' xyz and, by
``intensity_mode``, their mean intensity ("mean") or the weighted
intensity of its 5 nearest raw points ("knn5", sklearn's 5-NN transfer of
the reference). Points take their own voxel's scores ("own") or those of
the nearest live centroid ("nearest", cdist + argmin). The k-NN squared
distance is ``(|q|² − 2·q·r) + |r|²`` rounded in f32 in that order, and
ties go to the lower index, as in the reference's search.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.codes import pack_cell_keys
from benchmark.reference.nn import argsort_lex, gather_rows, segment_sum

KNN_INTENSITY_WEIGHTS = (0.4, 0.3, 0.2, 0.05, 0.05)
BAD_DIST = 1.0e30


class Voxels(NamedTuple):
    raw: torch.Tensor          # (B, V, 4) centroid xyz + intensity
    coords: torch.Tensor       # (B, V, 3) int32 cell coords
    mask: torch.Tensor         # (B, V) live voxels
    point_voxel: torch.Tensor  # (B, P) int64 voxel of each point
    point_ok: torch.Tensor     # (B, P) valid point whose voxel fit


def _take(x, idx):
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return gather_rows(x, idx)


def _sq_norm(x):
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
        + x[..., 2] * x[..., 2]


def knn(queries, refs, ref_mask, k, chunk=1 << 24):
    """The k nearest valid refs of every query: (distances (B, Q, k),
    indices (B, Q, k) int64), in (distance, index) order."""
    B, Q, _ = queries.shape
    R = refs.shape[1]
    qn, rn = _sq_norm(queries), _sq_norm(refs)
    rows = max(1, chunk // R)
    dist, idx = [], []
    for s in range(0, Q, rows):
        q = queries[:, s:s + rows, None, :]
        r = refs[:, None, :, :]
        dot = (q[..., 0] * r[..., 0] + q[..., 1] * r[..., 1]) \
            + q[..., 2] * r[..., 2]
        d = (qn[:, s:s + rows, None] - 2.0 * dot) + rn[:, None, :]
        d = torch.where(ref_mask[:, None, :], d, BAD_DIST)
        best_d, best_i = [], []
        for _ in range(k):
            a = d.argmin(dim=-1, keepdim=True)
            best_d.append(d.gather(-1, a))
            best_i.append(a)
            d.scatter_(-1, a, BAD_DIST)
        dist.append(torch.cat(best_d, -1))
        idx.append(torch.cat(best_i, -1))
    return torch.cat(dist, 1), torch.cat(idx, 1)


def voxelize(points, point_mask, voxel_size, capacity, intensity_mode):
    B, P, _ = points.shape
    dev = points.device
    xyz = points[..., :3]
    grid = torch.floor(xyz / voxel_size).to(torch.int32)
    hi, lo = pack_cell_keys(grid)
    perm = argsort_lex(hi, lo, point_mask)
    hi_s, lo_s = _take(hi, perm), _take(lo, perm)
    valid_s = _take(point_mask, perm)
    new = torch.ones((B, P), dtype=torch.int32, device=dev)
    new[:, 1:] = ((hi_s[:, 1:] != hi_s[:, :-1])
                  | (lo_s[:, 1:] != lo_s[:, :-1])).to(torch.int32)
    new = torch.where(valid_s, new, 0)
    vid_s = torch.cumsum(new, dim=1, dtype=torch.int32) - 1
    ok_s = valid_s & (vid_s >= 0) & (vid_s < capacity)
    seg = torch.where(ok_s, vid_s, capacity).to(torch.int64)
    pts_s = torch.where(ok_s[..., None], _take(points, perm), 0.0)
    sums = segment_sum(torch.cat([pts_s.float(),
                                  ok_s[..., None].float()], -1),
                       seg, capacity)
    counts = sums[..., 4]
    mask = counts > 0
    denom = counts.clamp_min(1.0)[..., None]
    centroid = sums[..., :3] / denom
    point_voxel = torch.empty((B, P), dtype=torch.int64, device=dev)
    point_voxel.scatter_(1, perm, vid_s.clamp(0, capacity - 1).long())
    point_ok = torch.empty((B, P), dtype=torch.bool, device=dev)
    point_ok.scatter_(1, perm, ok_s)
    if intensity_mode == "mean":
        intensity = sums[..., 3:4] / denom
    elif intensity_mode == "knn5":
        w = torch.tensor(KNN_INTENSITY_WEIGHTS, device=dev)
        _, idx = knn(centroid, xyz, point_mask, len(KNN_INTENSITY_WEIGHTS))
        near = torch.gather(points[..., 3], 1, idx.reshape(B, -1))
        intensity = torch.where(
            mask, (near.reshape(B, capacity, -1) * w).sum(-1), 0.0)[..., None]
    else:
        raise ValueError(f"unknown intensity_mode: {intensity_mode!r}")
    raw = torch.where(mask[..., None], torch.cat([centroid, intensity], -1),
                      0.0)
    idx = torch.arange(P, dtype=torch.int64, device=dev).expand(B, P)
    first = torch.full((B, capacity + 1), P, dtype=torch.int64, device=dev)
    first.scatter_reduce_(1, seg, torch.where(ok_s, idx, P), "amin",
                          include_self=True)
    first = first[:, :capacity].clamp(0, P - 1)
    coords = torch.where(mask[..., None], _take(_take(grid, perm), first), 0)
    return Voxels(raw, coords, mask, point_voxel, point_ok)


def devoxelize(mode, vox: Voxels, points, point_mask, voxel_scores):
    """Per-voxel scores (B, V, C) onto the points: (B, P, C)."""
    if mode == "own":
        vals = gather_rows(voxel_scores, vox.point_voxel)
        return torch.where(vox.point_ok[..., None], vals, 0.0)
    if mode == "nearest":
        _, idx = knn(points[..., :3], vox.raw[..., :3], vox.mask, 1)
        vals = gather_rows(voxel_scores, idx[..., 0])
        return torch.where(point_mask[..., None], vals, 0.0)
    raise ValueError(f"unknown devoxelize_mode: {mode!r}")
