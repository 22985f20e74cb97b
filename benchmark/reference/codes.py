"""Space-filling-curve codes (Morton / Hilbert) on integer tensors.

A frozen copy of the program's plain code, so that the reference shares no
module with what it checks: a 48-bit code (16 bits per axis) as an int32
pair ``(hi, lo)``, lo's bit 31 flipped in :func:`serialization_keys` so that
a signed lexicographic sort gives the unsigned curve order.
"""

from __future__ import annotations

import torch

GRID_BITS = 16
_OFF = 1 << (GRID_BITS - 1)
_MASK = (1 << GRID_BITS) - 1

SERIALIZATION_ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def _to_int32(x):
    """int64 holding a 32-bit pattern → the int32 with that pattern."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _split(code):
    """48-bit int64 code → (hi, lo) int32, lo's bit 31 as its sign bit."""
    return (code >> 32).to(torch.int32), _to_int32(code)


def pack_cell_keys(grid_coords):
    """Pack (..., 3) integer grid coords into 2-int32 lexicographic keys.

    Non-interleaved (plain row-major cell id) — for grouping points by
    cell. x sits in hi, (y, z) packed into lo at GRID_BITS each; lo is NOT
    bit-flipped (the JAX voxelizer sorts it signed as it is).
    """
    g = grid_coords.to(torch.int64) + _OFF
    hi = (g[..., 0] & _MASK).to(torch.int32)
    lo = _to_int32(((g[..., 1] & _MASK) << GRID_BITS) | (g[..., 2] & _MASK))
    return hi, lo


def _spread3(v):
    """Move bit j of a 16-bit int64 value to bit 3j."""
    v = v & 0x1FFFFF
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return v


def _interleave3(x, y, z):
    """Bit j of (x, y, z) lands at code position 3j + (2, 1, 0)."""
    return (_spread3(x) << 2) | (_spread3(y) << 1) | _spread3(z)


def _to_grid_uint(grid_coords):
    """Offset signed grid coords into [0, 2^GRID_BITS) as int64."""
    g = (grid_coords.to(torch.int64) + _OFF).clamp(0, _MASK)
    return g[..., 0], g[..., 1], g[..., 2]


def morton_encode(grid_coords):
    """Z-order code of (..., 3) grid coords → (hi, lo) int32 tensors."""
    return _split(_interleave3(*_to_grid_uint(grid_coords)))


def _hilbert_code(grid_coords):
    """Skilling's transpose algorithm (AIP Conf. Proc. 707, 381 (2004)),
    as in the JAX package: axes → Hilbert transpose → bit-interleave."""
    X = list(_to_grid_uint(grid_coords))
    n = 3
    M = 1 << (GRID_BITS - 1)
    Q = M
    while Q > 1:
        Pm = Q - 1
        for i in range(n):
            cond = (X[i] & Q) > 0
            t = (X[0] ^ X[i]) & Pm
            x0 = torch.where(cond, X[0] ^ Pm, X[0] ^ t)
            if i != 0:
                X[i] = torch.where(cond, X[i], X[i] ^ t)
            X[0] = x0
        Q >>= 1
    for i in range(1, n):
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    Q = M
    while Q > 1:
        t = torch.where((X[n - 1] & Q) > 0, t ^ (Q - 1), t)
        Q >>= 1
    return _interleave3(*(x ^ t for x in X))


def hilbert_encode(grid_coords):
    """Hilbert-curve code of (..., 3) grid coords → (hi, lo) int32."""
    return _split(_hilbert_code(grid_coords))


def serialization_keys(grid_coords, order):
    """Sort keys (hi, lo) int32 for one order of SERIALIZATION_ORDERS, lo
    with bit 31 flipped (signed lexicographic = unsigned code order)."""
    if order.endswith("-trans"):
        # x and y swapped by slices: an index list would be a host tensor
        # copied to the device on every call
        grid_coords = torch.cat([grid_coords[..., 1:2], grid_coords[..., :1],
                                 grid_coords[..., 2:]], dim=-1)
        order = order[: -len("-trans")]
    if order == "z":
        code = _interleave3(*_to_grid_uint(grid_coords))
    elif order == "hilbert":
        code = _hilbert_code(grid_coords)
    else:
        raise ValueError(f"unknown serialization order: {order!r}")
    return _split(code ^ (1 << 31))
