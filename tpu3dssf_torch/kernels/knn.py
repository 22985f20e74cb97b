"""k nearest neighbours by squared L2 distance: the CUDA kernel K7.

Port of ``tpu3dssf.kernels.knn.knn_pallas`` (TPU kernel ``_knn_kernel``,
knn.py:40): ``knn_f32`` in ``csrc/knn.cu``, launched by the C++ kernel of
the op ``tpu3dssf::knn`` (``csrc/ops_cuda.cpp``).
It takes a whole batch in one call, any Q and R, and k ≤ 8. A call is two
or three device kernels: the refs packed once; the scan, whose blocks take
equal runs of the call's (query unit, ref tile) pairs, so that a unit's
refs may be cut into segments, each giving the unit's queries their own
top-k (:func:`plan`); and, where a unit is cut, the merge of those lists.
The plain version of the whole is :func:`topk_neighbors_reference`. The
op ``tpu3dssf::knn`` (:mod:`tpu3dssf_torch.kernels.ops`) dispatches by
device: a CUDA tensor launches the kernel and counts it as K7 (read as
``LAUNCHES`` here), a CPU tensor takes the plain version. The kernel and the
plain version round the same f32 operations in the same order and are
bit-identical on the card.
"""

from __future__ import annotations

import torch

from tpu3dssf_torch.kernels import modules

MAX_K = 8
# distance of a masked ref and of an unfilled slot (the kernel's kBad)
BAD_DIST = 1e30


def __getattr__(name):
    """K7's launch counter, ``LAUNCHES``."""
    return modules.counter("knn", name)


def __dir__():
    return sorted([*globals(), *modules.counter_names("knn")])


def plan(B, Q, R, k):
    """``knn_plan`` of ``csrc/knn.cu`` on the current device (the op
    ``tpu3dssf_cuda::knn_plan`` of the CUDA library): (the scan's blocks,
    the most segments a unit of queries is cut into, entries of each
    partial list, bytes of the pack kernel's flags); a merge kernel runs
    where the second is above 1. ``knn_f32`` takes the blocks and the
    entries, and refuses entries that are not its own plan's for those
    blocks."""
    return tuple(torch.ops.tpu3dssf_cuda.knn_plan(B, Q, R, k))


def _check(queries, refs, ref_mask, k):
    if queries.device.type != "cuda":
        raise ValueError(f"knn: no kernel for device {queries.device} (the "
                         "plain version is topk_neighbors_reference)")
    check_layout(queries, refs, ref_mask, k)


def check_layout(queries, refs, ref_mask, k):
    """The kernel's contract on shapes, dtypes and devices: everything but
    the device type, which :func:`_check` adds."""
    if queries.dim() != 3 or queries.shape[-1] != 3 or refs.dim() != 3 \
            or refs.shape[-1] != 3 or refs.shape[0] != queries.shape[0]:
        raise ValueError(f"knn: queries (B, Q, 3) and refs (B, R, 3), got "
                         f"{tuple(queries.shape)} and {tuple(refs.shape)}")
    B, R = refs.shape[:2]
    if tuple(ref_mask.shape) != (B, R) or ref_mask.dtype != torch.bool:
        raise ValueError(f"knn: ref_mask must be bool (B, R) = {(B, R)}, got "
                         f"{ref_mask.dtype} {tuple(ref_mask.shape)}")
    for name, x in (("queries", queries), ("refs", refs)):
        if x.dtype != torch.float32:
            raise TypeError(f"knn: {name} must be float32, got {x.dtype}")
    if refs.device != queries.device or ref_mask.device != queries.device:
        raise ValueError("knn: queries, refs and ref_mask must be on one "
                         "device")
    if not 1 <= k <= min(MAX_K, R) or queries.shape[1] < 1 or B < 1:
        raise ValueError(f"knn: needs 1 ≤ k ≤ min({MAX_K}, R) and "
                         f"non-empty shapes, got k={k}, queries "
                         f"{tuple(queries.shape)}, refs {tuple(refs.shape)}")


def knn(queries, refs, ref_mask, k):
    """The k nearest valid refs of every query, on the card: the op
    ``tpu3dssf::knn`` on CUDA tensors, counted as K7.

    Args:
      queries: (B, Q, 3) float32 CUDA tensor.
      refs: (B, R, 3) float32 on the same device.
      ref_mask: (B, R) bool; masked refs are never chosen.
      k: 1 ≤ k ≤ min(8, R).

    Returns (distances (B, Q, k) float32, indices (B, Q, k) int32) in
    (distance, index) order; slots a query cannot fill (fewer than k valid
    refs) hold (:data:`BAD_DIST`, 0). Raises on anything else, on a CPU
    tensor, and when the build or the launch fails.
    """
    _check(queries, refs, ref_mask, k)
    return torch.ops.tpu3dssf.knn(queries, refs, ref_mask, k)


def topk_neighbors_reference(queries, refs, ref_mask, k, chunk=1 << 24):
    """Plain PyTorch version of K7: the k nearest valid refs per query.

    Same function as the JAX package's ``_tiled_topk_neighbors`` (its XLA
    path): squared distances ``(|q|² − 2·q·r) + |r|²`` with every product
    and sum rounded in f32 in that order (written elementwise, so no matmul
    and no fused multiply-add: the kernel does the same operations and
    both are bit-identical), masked refs at :data:`BAD_DIST`, then k
    rounds of argmin (first index of the minimum) that each set the winner
    to :data:`BAD_DIST`. Neighbours come in (distance, index) order;
    a query with fewer than k valid refs gets (BAD_DIST, 0) in the
    slots left over. Rows of queries are taken ``chunk // R`` at a time,
    so no (Q, R) matrix exists for the whole sample.

    Args:
      queries: (B, Q, 3) float32; refs: (B, R, 3) float32; ref_mask:
        (B, R) bool; k: neighbours per query (1 ≤ k ≤ R).

    Returns (distances (B, Q, k) float32, indices (B, Q, k) int32).
    """
    B, Q, _ = queries.shape
    R = refs.shape[1]
    qn = _sq_norm(queries)                                # (B, Q)
    rn = _sq_norm(refs)                                   # (B, R)
    rows = max(1, chunk // R)
    dist, idx = [], []
    for s in range(0, Q, rows):
        q = queries[:, s:s + rows, None, :]               # (B, q, 1, 3)
        r = refs[:, None, :, :]                           # (B, 1, R, 3)
        dot = (q[..., 0] * r[..., 0] + q[..., 1] * r[..., 1]) \
            + q[..., 2] * r[..., 2]
        d = (qn[:, s:s + rows, None] - 2.0 * dot) + rn[:, None, :]
        d = torch.where(ref_mask[:, None, :], d, BAD_DIST)
        best_d, best_i = [], []
        for _ in range(k):
            a = d.argmin(dim=-1, keepdim=True)            # first minimum
            best_d.append(d.gather(-1, a))
            best_i.append(a)
            d.scatter_(-1, a, BAD_DIST)
        dist.append(torch.cat(best_d, -1))
        idx.append(torch.cat(best_i, -1))
    return torch.cat(dist, 1), torch.cat(idx, 1).to(torch.int32)


def _sq_norm(x):
    """(x·x + y·y) + z·z in f32, the JAX package's order."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
        + x[..., 2] * x[..., 2]
