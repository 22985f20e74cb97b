"""k nearest neighbours by squared L2 distance: the CUDA kernel K7.

Port of ``tpu3dssf.kernels.knn.knn_pallas`` (TPU kernel ``_knn_kernel``,
knn.py:40): ``knn_f32`` in ``csrc/knn.cu``, counted in :data:`LAUNCHES`.
:func:`knn` takes a whole batch in one call, any Q and R, and k ≤ 8. A
call is two or three device kernels: the refs packed once; the scan, whose
blocks take equal runs of the call's (query unit, ref tile) pairs, so that
a unit's refs may be cut into segments, each giving the unit's queries
their own top-k (:func:`plan`); and, where a unit is cut, the merge of
those lists. The plain version of the whole is
:func:`tpu3dssf_torch.voxel.voxelize.topk_neighbors_reference`; the
parity modes of :mod:`tpu3dssf_torch.voxel.voxelize` route a CUDA tensor
here and a CPU tensor there. The kernel and the plain version round the
same f32 operations in the same order and are bit-identical on the card.
"""

from __future__ import annotations

import ctypes

import torch

from tpu3dssf_torch.kernels import _build

_SOURCE = "knn.cu"
MAX_K = 8
# distance of a masked ref and of an unfilled slot (the kernel's kBad)
BAD_DIST = 1e30

# kernel launches made in this process
LAUNCHES = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load_library(_SOURCE)
    lib.knn_f32.argtypes = [_PTR] * 9 + [_INT] * 5 + [ctypes.c_longlong,
                                                      _PTR]
    lib.knn_f32.restype = ctypes.c_int
    lib.knn_plan.argtypes = [_INT] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.knn_plan.restype = ctypes.c_int
    return lib


def plan(B, Q, R, k):
    """``knn_plan`` of ``csrc/knn.cu`` on the current device: (the scan's
    blocks, the most segments a unit of queries is cut into, entries of
    each partial list, bytes of the pack kernel's flags); a merge kernel
    runs where the second is above 1. ``knn_f32`` takes the blocks and
    the entries, and refuses entries that are not its own plan's for
    those blocks."""
    out = (ctypes.c_longlong * 4)()
    err = _lib().knn_plan(B, Q, R, k, out)
    if err != 0:
        raise RuntimeError(f"knn: knn_plan failed with cudaError_t {err} "
                           f"(B={B}, Q={Q}, R={R}, k={k})")
    return tuple(out)


def _check(queries, refs, ref_mask, k):
    if queries.device.type != "cuda":
        raise ValueError(f"knn: no kernel for device {queries.device} (the "
                         "plain version is voxelize.topk_neighbors_reference)")
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
    """The k nearest valid refs of every query, on the card.

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
    global LAUNCHES
    _check(queries, refs, ref_mask, k)
    queries, refs = queries.contiguous(), refs.contiguous()
    mask = ref_mask.contiguous().view(torch.uint8)
    B, Q, _ = queries.shape
    R = refs.shape[1]
    dev = queries.device
    lib = _lib()
    with torch.cuda.device(dev):
        blocks, segs, part, nflags = plan(B, Q, R, k)
        dist = torch.empty((B, Q, k), dtype=torch.float32, device=dev)
        idx = torch.empty((B, Q, k), dtype=torch.int32, device=dev)
        # scratch: the packed refs, the pack kernel's flags, the partial
        # lists
        packed = torch.empty((B, R, 4), dtype=torch.float32, device=dev)
        flags = torch.empty(nflags, dtype=torch.uint8, device=dev)
        part_d = torch.empty(part, dtype=torch.float32, device=dev)
        part_i = torch.empty(part, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_f32(
            queries.data_ptr(), refs.data_ptr(), mask.data_ptr(),
            dist.data_ptr(), idx.data_ptr(), packed.data_ptr(),
            flags.data_ptr(), part_d.data_ptr(), part_i.data_ptr(), B, Q, R,
            k, blocks, part, stream)
    if err != 0:
        raise RuntimeError(f"knn: kernel launch failed with cudaError_t "
                           f"{err} (B={B}, Q={Q}, R={R}, k={k}, {segs} "
                           f"segments a unit at most)")
    LAUNCHES += 1
    return dist, idx
