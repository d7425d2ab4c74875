"""Native host code of the port: the C++ UFP packer (``packing.cpp``),
built with g++ into ``glsdet_tpu_torch/_build/`` at first use and called
through ctypes (the call releases the GIL, so frames pack in parallel on
the pipeline's thread pool).  ``native/kernels.py`` builds the CUDA
kernels the same way.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from glsdet_tpu_torch.native.build import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "packing.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_D = ctypes.POINTER(ctypes.c_double)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_shared(
                "ufp", [_SRC], ["g++", "-O3", "-fPIC", "-std=c++17"],
                ["g++", "-shared"]))
            lib.ufp_pack.restype = ctypes.c_int
            lib.ufp_pack.argtypes = [
                _D, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_double, _D, _D]
            lib.ufp_pack_fit.restype = ctypes.c_int
            lib.ufp_pack_fit.argtypes = [
                _D, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, _D, ctypes.c_int, _D, _D, _D]
            _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def _rows(out: np.ndarray, r: int, max_regions: int) -> np.ndarray:
    """Padded, floored (max_regions, 7) float32 rows, truncated like
    ``ufp.assembly.regions_to_array``."""
    rows = np.zeros((max_regions, 7), np.float32)
    k = min(r, max_regions)
    rows[:k] = np.floor(out[:k])
    return rows


def unified_foreground_packing_rows(
    boxes: np.ndarray, scale: float, input_shape: Sequence[float],
    max_regions: int, width_min: float = 300.0, width_max: float = 2666.0,
) -> Tuple[np.ndarray, int, float, float]:
    """UFP packing straight to padded (max_regions, 7) rows.

    Returns ``(rows, n_regions, mosaic_w, mosaic_h)``."""
    lib = get_lib()
    boxes = np.ascontiguousarray(np.asarray(boxes, np.float64).reshape(-1, 4))
    n = boxes.shape[0]
    if n == 0:
        return np.zeros((max_regions, 7), np.float32), 0, 0.0, 0.0
    out = np.zeros((n, 7), np.float64)
    wh = np.zeros((2,), np.float64)
    r = lib.ufp_pack(_ptr(boxes), n, float(scale), float(input_shape[0]),
                     float(input_shape[1]), float(width_min),
                     float(width_max), _ptr(out), _ptr(wh))
    if r < 0:
        raise RuntimeError("ufp_pack failed")
    return _rows(out, r, max_regions), r, float(wh[0]), float(wh[1])


def unified_foreground_packing_rows_fit(
    boxes: np.ndarray, scale: float, input_shape: Sequence[float],
    max_regions: int, buckets: Sequence[float],
) -> Tuple[np.ndarray, int, float, float, Optional[int]]:
    """Bucket-fit twin of :func:`unified_foreground_packing_rows`: packs
    directly at the canvas ladder's widths and returns the smallest
    bucket the regions fit.

    Returns ``(rows, n_regions, mosaic_w, mosaic_h, bucket)``; ``bucket``
    is None when no ladder entry fit (reference layout; the caller
    buckets it)."""
    lib = get_lib()
    boxes = np.ascontiguousarray(np.asarray(boxes, np.float64).reshape(-1, 4))
    n = boxes.shape[0]
    if n == 0:
        return np.zeros((max_regions, 7), np.float32), 0, 0.0, 0.0, None
    bkt = np.ascontiguousarray(np.asarray(buckets, np.float64))
    out = np.zeros((n, 7), np.float64)
    wh = np.zeros((2,), np.float64)
    chosen = np.zeros((1,), np.float64)
    r = lib.ufp_pack_fit(_ptr(boxes), n, float(scale), float(input_shape[0]),
                         float(input_shape[1]), _ptr(bkt), len(bkt),
                         _ptr(out), _ptr(wh), _ptr(chosen))
    if r < 0:
        raise RuntimeError("ufp_pack_fit failed")
    bucket = int(chosen[0]) if chosen[0] > 0 else None
    return (_rows(out, r, max_regions), r, float(wh[0]), float(wh[1]),
            bucket)
