"""Native host code of the port: the C++ UFP packer (``packing.cpp``)
and the zstd frame decoder with CRC-32C (``zstd.cpp``, which
``utils/orbax_read.py`` reads orbax checkpoints with), each built with g++
into ``glsdet_tpu_torch/_build/`` at first use and called through ctypes
(the call releases the GIL, so frames pack in parallel on the pipeline's
thread pool).  ``native/kernels.py`` builds the CUDA kernels the same way.
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
ZSTD_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "zstd.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_zstd: Optional[ctypes.CDLL] = None
_MSG = 256

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


def _pack(boxes: np.ndarray, scale: float, input_shape: Sequence[float],
          width_min: float, width_max: float
          ) -> Tuple[np.ndarray, float, float]:
    """The packer's raw float64 region rows ``(n_regions, 7)`` and the
    mosaic's (width, height)."""
    lib = get_lib()
    boxes = np.ascontiguousarray(np.asarray(boxes, np.float64).reshape(-1, 4))
    n = boxes.shape[0]
    if n == 0:
        return np.zeros((0, 7), np.float64), 0.0, 0.0
    out = np.zeros((n, 7), np.float64)
    wh = np.zeros((2,), np.float64)
    r = lib.ufp_pack(_ptr(boxes), n, float(scale), float(input_shape[0]),
                     float(input_shape[1]), float(width_min),
                     float(width_max), _ptr(out), _ptr(wh))
    if r < 0:
        raise RuntimeError("ufp_pack failed")
    return out[:r], float(wh[0]), float(wh[1])


def unified_foreground_packing_rows(
    boxes: np.ndarray, scale: float, input_shape: Sequence[float],
    max_regions: int, width_min: float = 300.0, width_max: float = 2666.0,
) -> Tuple[np.ndarray, int, float, float]:
    """UFP packing straight to padded (max_regions, 7) rows.

    Returns ``(rows, n_regions, mosaic_w, mosaic_h)``."""
    out, w, h = _pack(boxes, scale, input_shape, width_min, width_max)
    return _rows(out, len(out), max_regions), len(out), w, h


def unified_foreground_packing_native(
    boxes: np.ndarray, scale: float, input_shape: Sequence[float],
    width_min: float = 300.0, width_max: float = 2666.0,
):
    """The C++ packer with ``ufp/packing.py``'s API, as the JAX package's
    ``native.unified_foreground_packing_native``: ``(list[Region],
    mosaic_w, mosaic_h)``, the region fields the packer's unfloored
    float64 values."""
    from glsdet_tpu_torch.ufp.packing import Region

    out, w, h = _pack(boxes, scale, input_shape, width_min, width_max)
    return [Region(x1=row[0], y1=row[1], w=row[2], h=row[3], new_x=row[4],
                   new_y=row[5], scale_factor=int(row[6]))
            for row in out], w, h


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


def zstd_lib() -> ctypes.CDLL:
    """The zstd decoder's library, built at first use."""
    global _zstd
    with _lock:
        if _zstd is None:
            lib = ctypes.CDLL(build_shared(
                "zstd", [ZSTD_SRC], ["g++", "-O3", "-fPIC", "-std=c++17"],
                ["g++", "-shared"]))
            lib.zstd_decompress.restype = ctypes.c_int
            lib.zstd_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_char_p, ctypes.c_int]
            lib.zstd_content_size.restype = ctypes.c_int64
            lib.zstd_content_size.argtypes = [ctypes.c_char_p,
                                              ctypes.c_size_t]
            lib.crc32c.restype = ctypes.c_uint32
            lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_uint32]
            _zstd = lib
    return _zstd


def _zstd_call(data: bytes, out: np.ndarray) -> Tuple[int, int]:
    """(return code, bytes written) of one decode of ``data`` into
    ``out``; a corrupt frame raises ``ValueError``."""
    n = ctypes.c_size_t(0)
    msg = ctypes.create_string_buffer(_MSG)
    rc = zstd_lib().zstd_decompress(data, len(data), out.ctypes.data,
                                    out.nbytes, ctypes.byref(n), msg, _MSG)
    if rc == 1:
        raise ValueError(f"corrupt zstd data: {msg.value.decode()}")
    return rc, n.value


def zstd_decompress_into(data: bytes, out: np.ndarray) -> int:
    """Decode every zstd frame of ``data`` (skippable frames skipped)
    into the C-contiguous buffer ``out``; returns the bytes written.
    Corrupt or truncated data, a checksum mismatch, a dictionary frame or
    output larger than ``out`` raise ``ValueError``."""
    if not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("out must be a writeable C-contiguous array")
    data = bytes(data)
    rc, n = _zstd_call(data, out)
    if rc == 2:
        raise ValueError(f"zstd data decodes to more than {out.nbytes} "
                         "bytes")
    return n


def zstd_decompress(data: bytes) -> bytes:
    """Decode every zstd frame of ``data`` (skippable frames skipped).
    The frames' stated content sizes size the output; where a frame does
    not state its size the buffer grows until it holds the result.
    Corrupt or truncated data, a checksum mismatch or a dictionary frame
    raise ``ValueError`` naming the byte offset."""
    data = bytes(data)
    stated = zstd_lib().zstd_content_size(data, len(data))
    cap = stated if stated >= 0 else max(4 * len(data), 1 << 16)
    while True:
        out = np.empty(max(int(cap), 1), np.uint8)
        rc, n = _zstd_call(data, out)
        if rc == 0:
            return out[:n].tobytes()
        cap = 2 * out.nbytes


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    data = bytes(data)
    return int(zstd_lib().crc32c(data, len(data), crc))
