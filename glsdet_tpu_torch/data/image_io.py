"""Reading and writing frames without OpenCV or PIL.

The JAX package reads frames with ``cv2.imread`` + ``cvtColor(BGR2RGB)``
(``data/coco.py``), request bodies with ``cv2.imdecode`` (``serve.py``)
and sizes with PIL (``data/visdrone.py``); the GPU machine has none of
them, so the port reads them itself, equal to ``cv2.imread(path)`` (and
``cv2.imdecode``) after BGR -> RGB value for value:

- JPEG: Huffman sequential (baseline and extended, SOF0/SOF1), 8-bit,
  grey or three components, any integral sampling (4:4:4, 4:2:2, 4:2:0,
  4:4:0, 4:1:1), restart intervals, decoded as libjpeg-turbo decodes by
  default (``native/jpeg.cpp``: the islow IDCT, fancy upsampling, its
  YCbCr tables), with the EXIF orientation of the first APP1 segment
  applied as ``IMREAD_COLOR`` applies it.  Progressive, arithmetic-coded,
  lossless, hierarchical, 12-bit and CMYK/YCCK files raise
  ``NotImplementedError`` naming ROADMAP.md queue A item 16.  Bytes cut
  short raise ``ValueError`` where ``cv2.imdecode`` returns ``None``;
  a file cut short inside its scan reads as ``cv2.imread`` reads it (mid
  grey from the block where the data ran out).  Entropy data libjpeg
  would decode only with warnings and substitutes (a bad Huffman code, a
  restart marker out of sequence) raises ``ValueError`` (ROADMAP.md
  section C);
- PNG, every colour type (grey, RGB, palette, grey+alpha, RGBA), bit
  depths 1, 2, 4, 8 and 16, interlaced (Adam7) or not: the IDAT stream
  inflates with the standard library's ``zlib`` and its rows are
  unfiltered in C++ (``native/png.cpp``: Average and Paeth depend on the
  pixel to the left, a Python loop would take seconds a frame).  Grey is
  replicated into three channels (samples of 1, 2 and 4 bits scaled to
  8), a palette is looked up (indices past it are black, ``tRNS``
  ignored), alpha is dropped (not composited) and 16-bit samples keep
  their high byte, as libpng's ``strip_16`` under ``IMREAD_COLOR``;
- ``.npy`` arrays, (H, W, 3) uint8 RGB as they are stored, or (H, W)
  grey replicated;
- sizes from a PNG's ``IHDR`` or a JPEG's ``SOF`` header, for the
  dataset converters.

Both native sources build with g++ into ``glsdet_tpu_torch/_build/`` at
first use and are called through ctypes, which releases the GIL, so
loader and HTTP threads decode in parallel.

:func:`encode_png` writes 8-bit PNGs with per-row adaptive filters (the
filter whose residuals have the least sum of absolute values), so every
filter type occurs.  :func:`encode_jpeg` writes what
``cv2.imencode(".jpg", ...)`` writes at OpenCV's defaults (4:2:0, the
standard Huffman tables, a JFIF header) and the given quality: the same
quantised coefficients, so any decoder reads the same pixels from both.
``chip_smoke.py`` writes its synthetic datasets with them.
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

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
_JPEG_ITEM = "ROADMAP.md, queue A item 16"
# samples per pixel of the PNG colour types: grey, RGB, palette,
# grey+alpha, RGBA, and the bit depths each allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_MSG = 256


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_shared(
                "image_io", [os.path.join(_NATIVE, "png.cpp"),
                             os.path.join(_NATIVE, "jpeg.cpp")],
                ["g++", "-O3", "-fPIC", "-std=c++17"], ["g++", "-shared"]))
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.jpeg_header.restype = ctypes.c_int
            lib.jpeg_header.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_decode.restype = ctypes.c_int
            lib.jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_int]
            lib.jpeg_encode.restype = ctypes.c_void_p
            lib.jpeg_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)]
            lib.jpeg_free.restype = None
            lib.jpeg_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def _jpeg_status(rc: int, msg) -> None:
    if rc == 1:
        raise ValueError(f"cannot decode JPEG: {msg.value.decode()}")
    if rc == 2:
        raise NotImplementedError(
            f"{msg.value.decode()} is not decoded ({_JPEG_ITEM})")


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation`` (EXIF orientations 2-8)."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, file_mode: bool = False) -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 3) uint8 RGB, EXIF orientation
    applied (module docstring).  Bytes that end before the image does
    are refused as ``cv2.imdecode`` refuses them; with ``file_mode`` they
    decode as ``cv2.imread`` decodes a file cut short (what is missing is
    mid grey)."""
    data = bytes(data)
    lib = _get_lib()
    dims = np.zeros(4, np.int32)
    msg = ctypes.create_string_buffer(_MSG)
    _jpeg_status(lib.jpeg_header(data, len(data), int(file_mode),
                                 dims.ctypes.data, msg, _MSG), msg)
    w, h, _, orientation = (int(v) for v in dims)
    out = np.empty((h, w, 3), np.uint8)
    _jpeg_status(lib.jpeg_decode(data, len(data), int(file_mode),
                                 out.ctypes.data, out.nbytes, msg, _MSG),
                 msg)
    return _orient(out, orientation)


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> the JPEG ``cv2.imencode(".jpg",
    BGR, [IMWRITE_JPEG_QUALITY, quality])`` writes (module docstring)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"expected uint8 (H, W) or (H, W, 3), got "
                         f"{img.dtype} {img.shape}")
    if img.shape[0] < 1 or img.shape[1] < 1 or max(img.shape[:2]) > 65500:
        raise ValueError(f"cannot encode a {img.shape[:2]} JPEG")
    lib = _get_lib()
    n = ctypes.c_size_t()
    ptr = lib.jpeg_encode(img.ctypes.data, img.shape[1], img.shape[0],
                          1 if img.ndim == 2 else 3, int(quality),
                          ctypes.byref(n))
    if not ptr:
        raise MemoryError("jpeg_encode")
    try:
        return ctypes.string_at(ptr, n.value)
    finally:
        lib.jpeg_free(ptr)


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> int:
    """Write :func:`encode_jpeg` of ``img`` to ``path``; returns the bytes
    written."""
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


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


def _unpack(raw: np.ndarray, rows: int, cols: int, depth: int,
            stride: int) -> np.ndarray:
    """(rows, stride) unfiltered bytes -> (rows, cols) samples, 8-bit."""
    b = raw.reshape(rows, stride)
    if depth == 8:
        return b[:, :cols]
    if depth == 16:
        return b[:, 0:2 * cols:2]                 # high byte (strip_16)
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    s = (b[:, :, None] >> shifts) & ((1 << depth) - 1)
    return s.reshape(rows, stride * per)[:, :cols]


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> (H, W, 3) uint8 RGB (module docstring)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header = None
    palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] \
            or interlace > 1:
        raise ValueError(f"bad PNG header: colour type {ctype}, bit depth "
                         f"{depth}, interlace {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    ch = _CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    lib = _get_lib()
    samples = np.empty((h, w * ch), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw = (w - x0 + dx - 1) // dx if w > x0 else 0
        ph = (h - y0 + dy - 1) // dy if h > y0 else 0
        if pw == 0 or ph == 0:
            continue
        stride = (pw * ch * depth + 7) // 8
        need = ph * (stride + 1)
        if len(raw) < pos + need:
            raise ValueError("PNG image data too short")
        out = np.empty((ph, stride), np.uint8)
        bad = lib.png_unfilter(raw[pos:].ctypes.data, ph, stride, bpp,
                               out.ctypes.data)
        if bad:
            raise ValueError(f"PNG row {-bad - 1}: unknown filter type")
        pos += need
        px = _unpack(out, ph, pw * ch, depth, stride).reshape(ph, pw, ch)
        samples.reshape(h, w, ch)[y0::dy, x0::dx] = px
    px = samples.reshape(h, w, ch)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if ctype in (0, 4):
        grey = px[..., 0]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_image(data: bytes) -> np.ndarray:
    """A PNG or JPEG file's bytes -> (H, W, 3) uint8 RGB, as
    ``cv2.imdecode(..., IMREAD_COLOR)`` after BGR -> RGB.  Bytes that are
    neither raise ``ValueError``."""
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    if data[:2] == JPEG_SIGNATURE:
        return decode_jpeg(data)
    raise ValueError("neither a PNG nor a JPEG file")


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG, JPEG or ``.npy`` frame, as
    ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` gives it.  A
    file that is missing or that ``cv2.imread`` could not read (where it
    returns ``None``) raises ``FileNotFoundError``, as the JAX loader
    does; a JPEG form the port does not decode raises
    ``NotImplementedError`` (module docstring)."""
    ext = os.path.splitext(path)[1].lower()
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if ext == ".npy":
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim not in (2, 3):
            raise ValueError(f"{path}: expected (H, W[, 3]) uint8")
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        return np.ascontiguousarray(img)
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data[:2] == JPEG_SIGNATURE:
            return decode_jpeg(data, file_mode=True)
        return decode_image(data)
    except ValueError as e:
        raise FileNotFoundError(f"{path}: {e}") from e


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


def write_image(path: str, img: np.ndarray) -> int:
    """Write an RGB (or grey) uint8 image by ``path``'s extension, as
    ``cv2.imwrite`` of its BGR picks the format: ``.jpg`` / ``.jpeg``
    through :func:`write_jpeg` (quality 95, OpenCV's default), ``.png``
    through :func:`write_png`; any other extension raises
    ``ValueError``.  Returns the bytes written."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        return write_jpeg(path, img)
    if ext == ".png":
        return write_png(path, img)
    raise ValueError(f"{path}: cannot write {ext or 'no'} extension "
                     "(the port writes .jpg, .jpeg and .png)")
