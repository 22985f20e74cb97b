"""k nearest neighbours by squared L2 distance: the CUDA kernel K7.

Port of ``tpu3dssf.kernels.knn.knn_pallas`` (TPU kernel ``_knn_kernel``,
knn.py:40): ``knn_f32`` in ``csrc/knn.cu``, counted in :data:`LAUNCHES`.
:func:`knn` takes a whole batch in one launch, any Q and R, and k ≤ 8.
Its plain version is
:func:`tpu3dssf_torch.voxel.voxelize.topk_neighbors_reference`; the
parity modes of :mod:`tpu3dssf_torch.voxel.voxelize` route a CUDA tensor
here and a CPU tensor there. The kernel and the plain version do the same
f32 operations in the same order and are bit-identical on the card.
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
    fn = _build.load_library(_SOURCE).knn_f32
    fn.argtypes = [_PTR] * 5 + [_INT] * 4 + [_PTR]
    fn.restype = ctypes.c_int
    return fn


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
    fn = _lib()
    dist = torch.empty((B, Q, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((B, Q, k), dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(queries.data_ptr(), refs.data_ptr(), mask.data_ptr(),
                 dist.data_ptr(), idx.data_ptr(), B, Q, R, k, stream)
    if err != 0:
        raise RuntimeError(f"knn: kernel launch failed with cudaError_t "
                           f"{err} (B={B}, Q={Q}, R={R}, k={k})")
    LAUNCHES += 1
    return dist, idx
