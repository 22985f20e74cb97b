"""ctypes bindings to the native C++ loader (csrc/libtpu3dssf_io.so).

The port's own copy of ``tpu3dssf/data/native.py``
(host code: the port imports nothing of the JAX package).

Falls back gracefully: ``get_native_loader()`` returns None when the
shared library hasn't been built (``make -C csrc``), and callers use the
pure-numpy path instead.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_SO_NAME = "libtpu3dssf_io.so"
_lib = None
_checked = False


def _so_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "csrc", _SO_NAME)


def get_native_loader():
    """Load (and memoize) the native library; None if unavailable."""
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    path = _so_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.tpu3dssf_load_sample.restype = ctypes.c_int64
    lib.tpu3dssf_load_sample.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.tpu3dssf_read_lidar_bin.restype = ctypes.c_int64
    lib.tpu3dssf_read_lidar_bin.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    _lib = lib
    return _lib


def load_sample_native(lidar_path: str, label_path: Optional[str],
                       lut: np.ndarray, capacity: int,
                       ignore_index: int = 0):
    """Read + remap + pack one sample entirely in C.

    Returns dict(points (cap,4) f32, labels (cap,) i32,
    point_valid (cap,) bool, mask (cap,) bool, num_points int) or None if
    the native lib is unavailable.
    """
    lib = get_native_loader()
    if lib is None:
        return None
    lut = np.ascontiguousarray(lut, dtype=np.uint8)
    points = np.empty((capacity, 4), np.float32)
    labels = np.empty((capacity,), np.int32)
    point_valid = np.empty((capacity,), np.uint8)
    mask = np.empty((capacity,), np.uint8)

    n = lib.tpu3dssf_load_sample(
        lidar_path.encode(), (label_path or "").encode(),
        lut.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(lut),
        capacity, ignore_index,
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        point_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if n < 0:
        raise IOError(f"native loader failed on {lidar_path}")
    return {
        "points": points,
        "labels": labels,
        "point_valid": point_valid.astype(bool),
        "mask": mask.astype(bool),
        "num_points": int(n),
    }
