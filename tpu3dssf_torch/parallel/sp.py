"""Sequence parallelism over the serialized point order.

Port of ``tpu3dssf.parallel.sp``. The space-filling-curve order is split
contiguously over a mesh axis; once each rank's span is a whole number of
windows, attention, LayerNorm, the matmuls and the mask algebra of a PTv3
block are local to the rank, and the one exchange in a block is the CPE
depthwise conv's one-row halo on each side (:func:`halo_rows`).

Under NCCL (one rank per card) the halos travel as JAX's ``ppermute``
does: each rank sends its first row to the previous rank and its last row
to the next, and receives theirs, point to point
(``dist.batch_isend_irecv``), O(B·C) bytes a block; the end ranks have one
neighbour, and their outer halo is zeros, as ``ppermute``'s fill. The
gradient goes back the same way. Under gloo (CPU ranks, or ranks sharing a
card) they travel by one ``all_gather`` of every rank's two edge rows, (S,
B, 2, C), and the gradient by one ``all_reduce`` of the same size.
:data:`P2P_OPS` counts the point-to-point sends and receives issued.

Scope, as in JAX: blocks attend along the CPE order itself (``perm=None``);
cross-order permutations and pooling are global gathers and are refused.
The block's state dict is the unsharded one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu3dssf_torch.parallel.mesh import Mesh, all_gather_rows

# point-to-point sends and receives issued by this process's halo exchanges
P2P_OPS = 0


def _exchange(sends, group, index, size):
    """Point to point with the neighbours along a group: ``sends`` is (to
    the previous rank, to the next one), each (B, C); returns (from the
    previous rank, from the next one), zeros at the ends."""
    global P2P_OPS
    ops = []
    got = [torch.zeros_like(x) for x in sends]
    for side, peer in ((0, index - 1), (1, index + 1)):
        if 0 <= peer < size:
            peer = dist.get_global_rank(group, peer)
            ops += [dist.P2POp(dist.isend, sends[side].contiguous(), peer,
                               group),
                    dist.P2POp(dist.irecv, got[side], peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        P2P_OPS += len(ops)
    return got


class _Halos(torch.autograd.Function):
    """(left, right) halo rows of this rank's span ``xs`` (B, n, C): the
    last row of the previous rank's span and the first row of the next
    one's, zeros at the ends (the global zero padding). ``p2p``: point to
    point with the neighbours, else one ``all_gather`` of every rank's
    edges."""

    @staticmethod
    def forward(ctx, xs, group, size, index, p2p):
        ctx.group, ctx.size, ctx.index, ctx.p2p = group, size, index, p2p
        ctx.shape = xs.shape
        if p2p:
            left, right = _exchange((xs[:, 0], xs[:, -1]), group, index,
                                    size)
            return left[:, None], right[:, None]
        edges = torch.stack([xs[:, 0], xs[:, -1]])           # (2, B, C)
        every = all_gather_rows(edges, group, size).unflatten(0, (size, 2))
        zero = torch.zeros_like(xs[:, :1])
        left = every[index - 1, 1][:, None] if index > 0 else zero
        right = every[index + 1, 0][:, None] if index < size - 1 else zero
        return left.clone(), right.clone()

    @staticmethod
    def backward(ctx, g_left, g_right):
        size, index = ctx.size, ctx.index
        B, n, C = ctx.shape
        like = g_left if g_left is not None else g_right
        g_left = (torch.zeros_like(like) if g_left is None else g_left)
        g_right = (torch.zeros_like(like) if g_right is None else g_right)
        gx = torch.zeros(ctx.shape, dtype=like.dtype, device=like.device)
        if ctx.p2p:
            # the left halo's gradient is the previous rank's last row's
            first, last = _exchange((g_left[:, 0], g_right[:, 0]), ctx.group,
                                    index, size)
            gx[:, 0] += first
            gx[:, n - 1] += last
            return gx, None, None, None, None
        every = torch.zeros((size, 2, B, C), dtype=like.dtype,
                            device=like.device)
        if index > 0:
            every[index - 1, 1] = g_left[:, 0]
        if index < size - 1:
            every[index + 1, 0] = g_right[:, 0]
        dist.all_reduce(every, group=ctx.group)
        gx[:, 0] += every[index, 0]
        gx[:, n - 1] += every[index, 1]
        return gx, None, None, None, None


def halo_rows(xs, mesh: Mesh, axis: str):
    """(left, right), each (B, 1, C): the neighbouring spans' edge rows
    over ``axis`` of ``mesh``; the exchange carries a gradient, point to
    point under NCCL."""
    return _Halos.apply(xs, mesh.group(axis), mesh.shape[axis],
                        mesh.coords[axis], mesh.backend == "nccl")


def sp_block_apply(block, x, mask, mesh: Mesh, axis: str = "seq"):
    """Run one ``PTv3Block`` sequence-parallel over ``mesh[axis]``.

    Args:
      block: a ``tpu3dssf_torch.models.ptv3.PTv3Block`` made with
        ``sp_axis=axis`` (its CPE takes its halos over that axis).
      x: (B, N, C) features in serialized order, whole on every rank.
      mask: (B, N) validity.
      mesh: the mesh holding ``axis``.

    Returns this rank's (B, N/S, C) span of the unsharded block's output.
    N must split into whole windows on every rank:
    ``N % (S · block.window) == 0``.
    """
    if block.sp_axis != axis:
        raise ValueError(f"block.sp_axis={block.sp_axis!r} must equal "
                         f"the mesh axis {axis!r}")
    n_sh = mesh.shape[axis]
    n = x.shape[1]
    if n % (n_sh * block.window):
        raise ValueError(
            f"N={n} must be a multiple of shards*window="
            f"{n_sh}*{block.window} so windows never span shards")
    span = n // n_sh
    lo = mesh.coords[axis] * span
    with mesh:
        return block(x[:, lo:lo + span], None, None, mask[:, lo:lo + span])
