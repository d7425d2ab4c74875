"""Build and load the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and link into one shared
library with a plain C interface, loaded with ctypes at first use (never
at import: the CPU tests import every module).  Each entry
point launches on the stream it is given and returns
``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional

from glsdet_tpu_torch.native.build import PKG_DIR, build_shared

CSRC = os.path.join(PKG_DIR, "csrc")
SOURCES = tuple(os.path.join(CSRC, f)
                for f in ("nms.cu", "paint.cu", "gn_quant.cu",
                          "bottleneck.cu"))
HEADERS = (os.path.join(CSRC, "ptx.cuh"),)
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = (*_ARCH, "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # boxes, valid, keep, mask, batch, k, stride, iou_thr, offset, stream
    "glsdet_nms_sorted": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
    # boxes, mask, batch, k, stride, iou_thr, offset, stream
    "glsdet_nms_mask": [_P, _P, _I, _I, _I, _F, _F, _P],
    # mask, valid, keep, batch, k, stride, stream
    "glsdet_nms_reduce": [_P, _P, _P, _I, _I, _I, _P],
    # src, n_src, src_h, src_w, idx, rows, batch, n_rows, out, out_h,
    # out_w, out_bf16, stream
    "glsdet_paint_mosaic": [_P, _I, _I, _I, _P, _P, _I, _I, _P, _I, _I, _I,
                            _P],
    # src, n_src, src_h, src_w, idx, rows, batch, n_rows, mean, inv_std,
    # out, hw, stream
    "glsdet_paint_mosaic_inputs": [_P, _I, _I, _I, _P, _P, _I, _I, _P, _P,
                                   _P, _I, _P],
    # y, gamma, beta, s_out, eps, batch, hw, c, groups, chunk, work,
    # counter, out, stream
    "glsdet_gn_relu_quant": [_P, _P, _P, _F, _F, _I, _I, _I, _I, _I, _P, _P,
                             _P, _P],
    # acc, deq, then as glsdet_gn_relu_quant from gamma on
    "glsdet_gn_relu_quant_acc": [_P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _I,
                                 _P, _P, _P, _P],
    # src_bytes, batch, hw, c, plan (int[5] out)
    "glsdet_gn_plan": [_I, _I, _I, _I, _P],
    # x, w1p, b1, w2p, b2, w3p, b3, out, batch, h, w, c, stream
    "glsdet_fused_bottleneck": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _P],
}


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def load_kernels() -> ctypes.CDLL:
    """The kernels library, built from the sources on first call."""
    global _lib
    with _lock:
        if _lib is None:
            nv = nvcc()
            lib = ctypes.CDLL(build_shared(
                "glsdet_kernels", SOURCES, [nv, *NVCC_FLAGS],
                [nv, *LINK_FLAGS], deps=HEADERS))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
