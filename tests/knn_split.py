"""The k-NN kernel's cut of the work (K7, ``csrc/knn.cu``) in plain Python
and PyTorch, for the tests: :func:`segments` repeats the kernel's
``Work`` (its runs and the segments they cut each unit into), and
:func:`topk_split_reference` runs the plain version on each segment and
merges the lists as ``knn_merge_kernel`` does. The CPU tests hold the
mirror bit for bit to the plain version of the whole; the card tests hold
:func:`segments` to the kernel's own plan (``knn.plan``)."""

import torch

from tpu3dssf_torch.voxel.voxelize import (KNN_BAD_DIST,
                                          topk_neighbors_reference)


def segments(units, tiles, blocks):
    """The units × tiles (unit, tile) pairs in unit-major order cut into
    P = min(blocks, units · tiles) runs, run p from floor(p · T / P); per
    unit, the [(first tile, end tile)] of its segments in ref order."""
    total = units * tiles
    blocks = min(blocks, total)
    starts = [p * total // blocks for p in range(blocks + 1)]
    out = [[] for _ in range(units)]
    for p in range(blocks):
        tau = starts[p]
        while tau < starts[p + 1]:
            unit, t0 = divmod(tau, tiles)
            t1 = min(tiles, t0 + starts[p + 1] - tau)
            out[unit].append((t0, t1))
            tau += t1 - t0
    return out


def topk_split_reference(queries, refs, ref_mask, k, blocks, tile=512,
                         unit=512):
    """The kernel's split: queries in units of ``unit``, refs in tiles of
    ``tile``, the work cut by :func:`segments` into ``blocks`` runs; the
    plain version on each segment (its indices shifted to the whole), then
    each unit's lists merged in ref order: an entry goes in where strictly
    nearer than the current k-th, from k slots of (KNN_BAD_DIST, 0).
    Bit-identical to ``topk_neighbors_reference``: a ref of the whole
    top-k is in its segment's top-k, and earlier segments hold lower
    indices, so ties still go to the lower index."""
    B, Q, _ = queries.shape
    R = refs.shape[1]
    nqb = -(-Q // unit)
    best_d = torch.full((B, Q, k), KNN_BAD_DIST, dtype=torch.float32,
                        device=queries.device)
    best_i = torch.zeros((B, Q, k), dtype=torch.int32, device=queries.device)
    for u, segs in enumerate(segments(B * nqb, -(-R // tile), blocks)):
        b, qb = divmod(u, nqb)
        rows = (slice(b, b + 1), slice(qb * unit, (qb + 1) * unit))
        for t0, t1 in segs:
            r0, r1 = t0 * tile, min(R, t1 * tile)
            part = topk_neighbors_reference(
                queries[rows], refs[b:b + 1, r0:r1],
                ref_mask[b:b + 1, r0:r1], min(k, r1 - r0))
            for d, i in zip(part[0].unbind(-1), (part[1] + r0).unbind(-1)):
                best_d[rows], best_i[rows] = _insert(best_d[rows],
                                                     best_i[rows], d, i)
    return best_d, best_i


def _insert(best_d, best_i, d, i):
    """The kernel's insertion, elementwise: (d, i) goes after every kept
    entry with distance <= d, where d is below the k-th distance."""
    enter = d < best_d[..., -1]
    after = best_d > d[..., None]            # kept entries farther than d
    before = torch.cat([torch.zeros_like(after[..., :1]), after[..., :-1]],
                       -1)                   # the slot before is farther
    shifted_d = torch.cat([best_d[..., :1], best_d[..., :-1]], -1)
    shifted_i = torch.cat([best_i[..., :1], best_i[..., :-1]], -1)
    new_d = torch.where(before, shifted_d, torch.where(after, d[..., None],
                                                       best_d))
    new_i = torch.where(before, shifted_i, torch.where(after, i[..., None],
                                                       best_i))
    return (torch.where(enter[..., None], new_d, best_d),
            torch.where(enter[..., None], new_i, best_i))
