"""Reading and writing training frames without OpenCV or PIL.

The JAX package reads frames with ``cv2.imread`` + ``cvtColor(BGR2RGB)``
(``data/coco.py``) and their sizes with PIL (``data/visdrone.py``); the
GPU machine has neither, so the port reads them itself:

- PNG, 8-bit grey, RGB or RGBA, not interlaced (what ``cv2.imwrite``
  writes for uint8 images): the IDAT stream inflates with the standard
  library's ``zlib`` and its rows are unfiltered in C++
  (``native/png.cpp``, built with g++ into ``glsdet_tpu_torch/_build/``
  at first use: Average and Paeth depend on the pixel to the left, a
  Python loop would take seconds a frame).  The result is what
  ``cv2.imread(path)`` returns after BGR -> RGB: grey is replicated into
  three channels, alpha is dropped (not composited).  Other PNGs raise
  ``NotImplementedError``;
- ``.npy`` arrays, (H, W, 3) uint8 RGB as they are stored, or (H, W)
  grey replicated;
- sizes from a PNG's ``IHDR`` or a JPEG's ``SOF`` header, for the
  dataset converters.

Decoding a JPEG raises ``NotImplementedError``: no decoder on the GPU
machine reproduces ``cv2.imread``'s libjpeg output bit for bit
(ROADMAP.md, queue A item 16).

:func:`encode_png` writes 8-bit PNGs with per-row adaptive filters (the
filter whose residuals have the least sum of absolute values), so every
filter type occurs; ``chip_smoke.py`` writes its synthetic dataset with
it.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

from glsdet_tpu_torch.native.build import build_shared

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "png.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_EXTS = (".jpg", ".jpeg")
_JPEG_ITEM = ("decoding JPEG frames is not ported (ROADMAP.md, queue A "
              "item 16); convert them to PNG")
# samples per pixel of the PNG colour types read: grey, RGB, RGBA
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_shared(
                "png", [_SRC], ["g++", "-O3", "-fPIC", "-std=c++17"],
                ["g++", "-shared"]))
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            _lib = lib
    return _lib


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"corrupt PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends before IEND")


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> (H, W, 3) uint8 RGB (module docstring)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if interlace:
        raise NotImplementedError("interlaced PNG")
    if ctype not in _CHANNELS or depth != 8:
        raise NotImplementedError(
            f"PNG colour type {ctype} at bit depth {depth}")
    ch = _CHANNELS[ctype]
    stride = w * ch
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data too short")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((h, stride), np.uint8)
    bad = _get_lib().png_unfilter(src.ctypes.data, h, stride, ch,
                                  out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {-bad - 1}: unknown filter type")
    px = out.reshape(h, w, ch)
    if ch == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG or ``.npy`` frame, as
    ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` gives it for a
    PNG.  A missing file raises ``FileNotFoundError``, a JPEG
    ``NotImplementedError``."""
    ext = os.path.splitext(path)[1].lower()
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if ext in JPEG_EXTS:
        raise NotImplementedError(f"{path}: {_JPEG_ITEM}")
    if ext == ".npy":
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim not in (2, 3):
            raise ValueError(f"{path}: expected (H, W[, 3]) uint8")
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        return np.ascontiguousarray(img)
    with open(path, "rb") as f:
        return decode_png(f.read())


def _jpeg_size(f) -> Tuple[int, int]:
    if f.read(2) != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    while True:
        byte = f.read(1)
        if not byte:
            raise ValueError("JPEG without a SOF header")
        if byte != b"\xff":
            continue
        marker = f.read(1)
        while marker == b"\xff":           # fill bytes
            marker = f.read(1)
        m = marker[0] if marker else 0
        if m == 0x01 or 0xD0 <= m <= 0xD9:  # markers without a length
            continue
        length, = struct.unpack(">H", f.read(2))
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            _prec, h, w = struct.unpack(">BHH", f.read(5))
            return w, h
        f.seek(length - 2, os.SEEK_CUR)


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of a PNG or JPEG frame from its header, without
    decoding the pixels (the converters' counterpart of PIL's
    ``Image.open(path).size``)."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head.startswith(PNG_SIGNATURE):
            if head[12:16] != b"IHDR":
                raise ValueError(f"{path}: PNG without IHDR first")
            w, h = struct.unpack(">II", head[16:24])
            return int(w), int(h)
        f.seek(0)
        return _jpeg_size(f)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> PNG bytes,
    each row filtered with the adaptive choice of the module
    docstring."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected uint8 (H, W[, C]), got {img.dtype} "
                         f"{img.shape}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    x = img.reshape(h, w * ch).astype(np.int16)
    a = np.zeros_like(x)
    a[:, ch:] = x[:, :-ch]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, ch:] = x[:-1, :-ch]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cands = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth])
    cands = (cands & 0xFF).astype(np.uint8)
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(axis=2)
    kind = cost.argmin(axis=0)
    rows = np.empty((h, 1 + w * ch), np.uint8)
    rows[:, 0] = kind
    rows[:, 1:] = cands[kind, np.arange(h)]
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> int:
    """Write :func:`encode_png` of ``img`` to ``path``; returns the bytes
    written."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
