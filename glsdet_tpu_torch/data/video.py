"""Video frames in and out without OpenCV: :class:`VideoReader` for
``cv2.VideoCapture`` + ``cv2.cvtColor(..., COLOR_BGR2RGB)`` and
:class:`VideoWriter` for ``cv2.VideoWriter(..., fourcc "mp4v", ...)``, as
``tools/predict.py``'s ``video`` mode uses them.

Reading takes the first video track of an ``.mp4``/``.m4v``/``.mov`` or
``.avi`` file (``data/video_container.py``) and decodes
- MPEG-4 Part 2 (``mp4v``, AVI ``FMP4``/``XVID``/``DIVX``/``DX50``/
  ``MP4V``) with ``native/mpeg4.cpp``: the luma planes equal FFmpeg's
  decoder's (``cv2.VideoCapture`` with ``CAP_PROP_CONVERT_RGB`` 0) bit for
  bit, and the RGB frames equal ``cv2.VideoCapture``'s BGR frames reversed
  (swscale's yuv2rgb, repeated in ``mpeg4.cpp: yuv420_to_rgb``);
- MJPEG (AVI ``MJPG``, ``.mp4`` ``jpeg``) of baseline 4:2:0 frames along
  FFmpeg's mjpeg route (``native/jpeg.cpp: jpeg_decode_yuv420``: its simple
  IDCT, then swscale's full-range yuv2rgb), not ``decode_jpeg``'s
  libjpeg-turbo route, which differs from the video decoder's by a few
  codes;
- H.264 (``.mp4`` ``avc1``/``avc3``, AVI ``H264``/``X264``/``h264``/
  ``x264``/``avc1``, raw Annex B ``.h264``/``.264``) of I and P pictures,
  CAVLC or CABAC, with ``native/h264.cpp``: the planes equal FFmpeg's
  decoder's bit for bit, and the RGB frames follow the stream's VUI as
  FFmpeg's pixel format and OpenCV's swscale call do (full range as
  yuvj420p, the matrix its matrix_coefficients names).  Every stream is
  read through its headers first, so that a form ``h264.cpp`` refuses
  (B slices, interlace, MMCO, ...) raises before any frame is returned.
Frame count, size and frame rate are the ones ``cv2.VideoCapture``
reports.  HEVC and every other codec, B- and S-VOPs, quarter-pel,
interlace and the other MPEG-4 tools ``mpeg4.cpp`` lists, the H.264 forms
``h264.cpp`` lists, streams tagged by XviD or DivX (FFmpeg decodes them
with other IDCTs and workarounds), other containers and the camera raise
``NotImplementedError`` naming ROADMAP.md, queue A item 19; no frame of
such a stream is returned.

Writing encodes MPEG-4 Part 2 with ``mpeg4.cpp``'s encoder (I- and P-VOPs,
a GOP of 12, quantiser :data:`QUANT`) into an ``.mp4``/``.m4v``/``.mov``
or ``.avi`` chosen by the extension; width and height drop an odd last
column and row, as ``cv2.VideoWriter`` does.  Frames go through BT.601
limited-range 4:2:0 (``mpeg4.cpp: rgb_to_yuv420``).

The native sources build with g++ into ``glsdet_tpu_torch/_build/`` at
first use and run on the host, as the JAX package's OpenCV does.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from glsdet_tpu_torch.data import image_io
from glsdet_tpu_torch.data.video_container import (AVI_EXTS, ITEM, MP4_EXTS,
                                                   VideoTrack,
                                                   AviWriter, Mp4Writer,
                                                   VideoOpenError, frame_rate,
                                                   open_track)
from glsdet_tpu_torch.native.build import build_shared

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_h264: Optional[ctypes.CDLL] = None
_MSG = 256
QUANT = 3   # the encoder's quantiser (cv2's writer settles at 3 on such clips)
GOP = 12    # an I-VOP every GOP frames, as cv2.VideoWriter's mp4v
# AVI fourccs for which FFmpeg takes an untagged stream for XviD's or
# DivX's and decodes it otherwise
_FOREIGN_FOURCCS = {"XVID", "XVIX", "RMP4", "ZMP4", "SIPP", "DIVX"}
# mpeg4.cpp's enum Tool: what the decoder has met in a stream
TOOLS = ("i_vops", "p_vops", "intra_mbs_in_p", "not_coded_mbs",
         "dquant_mbs", "ac_pred_mbs", "ac_pred_rescaled_blocks",
         "escape1", "escape2", "escape3")
_VOP = b"\x00\x00\x01\xb6"
# h264.cpp's enum Tool
H264_TOOLS = ("cavlc_slices", "cabac_slices", "idr_pictures", "i_pictures",
              "p_pictures", "i4x4", "i8x8", "i16x16", "i_pcm", "intra_in_p",
              "p16x16", "p16x8", "p8x16", "p8x8", "p8x8ref0", "sub8x4",
              "sub4x8", "sub4x4", "p_skip", "inter_8x8_transform",
              "ref_idx_above_0", "list_modification", "weighted_slices",
              "scaling_matrix_pictures", "constrained_intra_mbs",
              "deblock_idc0", "deblock_idc1", "deblock_idc2",
              "multi_slice_pictures", "poc_type0", "poc_type1", "poc_type2",
              "cropped_pictures", "full_range_pictures", "level_escapes",
              "qp_wraps", "cabac_init_idc0", "cabac_init_idc1",
              "cabac_init_idc2", "edge_mc_mbs", "coeff_token_flc_blocks")


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_shared(
                "video", [os.path.join(_NATIVE, "mpeg4.cpp")],
                ["g++", "-O3", "-fPIC", "-std=c++17"], ["g++", "-shared"],
                deps=[os.path.join(_NATIVE, "simple_idct.h")]))
            vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            msg = [ctypes.c_char_p, i]
            lib.m4v_open.restype = vp
            lib.m4v_open.argtypes = []
            lib.m4v_close.argtypes = [vp]
            lib.m4v_decode.restype = i
            lib.m4v_decode.argtypes = [vp, ctypes.c_char_p, sz,
                                       ctypes.POINTER(i), *msg]
            lib.m4v_size.argtypes = [vp, vp]
            lib.m4v_tools.argtypes = [vp, vp, i]
            lib.m4v_planes.argtypes = [vp, vp]
            lib.yuv420_to_rgb.argtypes = [vp, vp, vp, i, i, i, i, vp]
            lib.rgb_to_yuv420.argtypes = [vp, i, i, vp, vp, vp]
            lib.m4v_enc_open.restype = vp
            lib.m4v_enc_open.argtypes = [i, i, i, i, i, i, *msg]
            lib.m4v_enc_close.argtypes = [vp]
            lib.m4v_enc_header.restype = sz
            lib.m4v_enc_header.argtypes = [vp, vp, sz]
            lib.m4v_enc_frame.restype = sz
            lib.m4v_enc_frame.argtypes = [vp, vp, vp, vp, vp, sz,
                                          ctypes.POINTER(i), *msg]
            _lib = lib
    return _lib


def _get_h264() -> ctypes.CDLL:
    global _h264
    with _lock:
        if _h264 is None:
            lib = ctypes.CDLL(build_shared(
                "h264", [os.path.join(_NATIVE, "h264.cpp")],
                ["g++", "-O3", "-fPIC", "-std=c++17"], ["g++", "-shared"]))
            vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            lib.h264_open.restype = vp
            lib.h264_open.argtypes = [i]
            lib.h264_close.argtypes = [vp]
            lib.h264_nal.restype = i
            lib.h264_nal.argtypes = [vp, ctypes.c_char_p, sz,
                                     ctypes.POINTER(i), ctypes.c_char_p, i]
            lib.h264_end.restype = i
            lib.h264_end.argtypes = [vp, ctypes.c_char_p, i]
            lib.h264_info.argtypes = [vp, vp]
            lib.h264_tools.argtypes = [vp, vp, i]
            lib.h264_planes.argtypes = [vp, vp]
            _h264 = lib
    return _h264


def _status(rc: int, msg, path: str, source: str = "mpeg4.cpp") -> None:
    if rc == 2:
        raise NotImplementedError(
            f"{path}: {msg.value.decode(errors='replace')}: the port decodes "
            f"the features listed in glsdet_tpu_torch/native/{source} "
            f"({ITEM})")
    if rc:
        raise ValueError(f"{path}: corrupt video: "
                         f"{msg.value.decode(errors='replace')}")


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray,
               full_range: bool = False, matrix: int = 2) -> np.ndarray:
    """Planes of 4:2:0 video -> (H, W, 3) uint8 RGB, as swscale converts
    them for ``cv2.VideoCapture`` (limited range for MPEG-4, full range
    for MJPEG's yuvj420p; ``matrix``: an H.264 VUI's matrix_coefficients,
    2 (unspecified) converting as BT.601)."""
    h, w = y.shape
    if u.shape != v.shape or u.shape != ((h + 1) // 2, (w + 1) // 2):
        raise ValueError(f"4:2:0 planes of {y.shape}: chroma {u.shape}, "
                         f"{v.shape}")
    out = np.empty((h, w, 3), np.uint8)
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    _get_lib().yuv420_to_rgb(y.ctypes.data, u.ctypes.data, v.ctypes.data,
                             w, h, int(full_range), int(matrix),
                             out.ctypes.data)
    return out


def _split_annexb(data: bytes):
    """The NAL units of an Annex B byte stream (start codes and trailing
    zero bytes removed)."""
    out = []
    starts = []
    i = data.find(b"\x00\x00\x01")
    while i >= 0:
        starts.append(i + 3)
        i = data.find(b"\x00\x00\x01", i + 3)
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else len(data)
        nal = data[s:e].rstrip(b"\x00")
        if nal:
            out.append(nal)
    return out


def _split_lengths(data: bytes, size: int, path: str):
    """The NAL units of a sample of ``size``-byte length prefixes."""
    out, pos = [], 0
    while pos + size <= len(data):
        n = int.from_bytes(data[pos:pos + size], "big")
        pos += size
        if pos + n > len(data):
            raise ValueError(f"{path}: corrupt video: a NAL unit of {n} "
                             f"bytes runs past its sample")
        out.append(data[pos:pos + n])
        pos += n
    if pos != len(data):
        raise ValueError(f"{path}: corrupt video: a sample ends inside a "
                         f"NAL length")
    return out


def _parse_avcc(config: bytes, path: str):
    """(NAL length size, parameter set NAL units) of an ``avcC`` body."""
    if len(config) < 7 or config[0] != 1:
        raise ValueError(f"{path}: corrupt video: avcC version "
                         f"{config[:1].hex()}")
    size = (config[4] & 3) + 1
    sets, pos = [], 5
    for count_mask in (0x1F, 0xFF):
        if pos >= len(config):
            raise ValueError(f"{path}: corrupt video: avcC cut short")
        n = config[pos] & count_mask
        pos += 1
        for _ in range(n):
            k = int.from_bytes(config[pos:pos + 2], "big")
            sets.append(config[pos + 2:pos + 2 + k])
            pos += 2 + k
    if pos > len(config):
        raise ValueError(f"{path}: corrupt video: avcC cut short")
    return size, sets


class _H264Stream:
    """The NAL units of an H.264 track, sample by sample."""

    def __init__(self, track: VideoTrack):
        self.track = track
        self.size, self.sets = 0, []
        if track.container == "mp4":
            self.size, self.sets = _parse_avcc(track.config, track.path)

    def units(self) -> Iterator[bytes]:
        yield from self.sets
        t = self.track
        if t.container == "h264":  # raw: NAL units may span chunks
            rest = b""
            for chunk in t.samples():
                data = rest + chunk
                k = data.rfind(b"\x00\x00\x01")
                if k <= 0:
                    rest = data
                    continue
                rest = data[k:]
                yield from _split_annexb(data[:k])
            yield from _split_annexb(rest)
        elif self.size:
            for data in t.samples():
                yield from _split_lengths(data, self.size, t.path)
        else:
            for data in t.samples():
                yield from _split_annexb(data)


class VideoReader:
    """The frames of a video file as (H, W, 3) uint8 RGB, with ``fps``,
    ``width``, ``height`` and ``frame_count`` as ``cv2.VideoCapture``
    reports them.  ``seconds`` sums the time spent decoding."""

    def __init__(self, path: str):
        self._dec = None
        self.path = path
        self.track = open_track(path)
        self.fps = self.track.fps
        self.frame_count = self.track.frame_count
        self.seconds = 0.0
        # yuv2rgb's full range and matrix (H.264: the VUI's, per picture)
        self._colour = (self.track.codec == "mjpeg", 2)
        if self.track.codec == "mp4v":
            self._open_mp4v()
        elif self.track.codec == "h264":
            self._open_h264()
        else:
            self._open_mjpeg()

    def _open_mp4v(self) -> None:
        t = self.track
        config = t.config
        if not config and t.frame_count:
            first = next(t.samples())
            config = first[:max(first.find(_VOP), 0)]
        if (t.fourcc.upper() in _FOREIGN_FOURCCS
                and b"Lavc" not in config and b"FFmpe" not in config):
            raise NotImplementedError(
                f"{self.path}: an untagged MPEG-4 stream in an AVI marked "
                f"{t.fourcc!r}, which FFmpeg decodes as XviD's or DivX's "
                f"({ITEM})")
        # B- and S-VOPs are refused before any frame is decoded: every
        # sample's VOP header is read first
        for i, head in enumerate(t.samples(head=256)):
            k = head.find(_VOP)
            if 0 <= k < len(head) - 4 and head[k + 4] >> 6 >= 2:
                kind = "B" if head[k + 4] >> 6 == 2 else "S (sprite, GMC)"
                raise NotImplementedError(
                    f"{self.path}: sample {i} is a {kind}-VOP ({ITEM})")
        lib = _get_lib()
        self._dec = lib.m4v_open()
        self._feed(config)
        wh = np.zeros(2, np.int32)
        lib.m4v_size(self._dec, wh.ctypes.data)
        if not wh.all():
            self.close()
            raise VideoOpenError(f"{self.path}: no MPEG-4 VOL header")
        self.width, self.height = int(wh[0]), int(wh[1])

    def _h264_nal(self, dec, nal: bytes) -> bool:
        msg = ctypes.create_string_buffer(_MSG)
        got = ctypes.c_int()
        rc = _get_h264().h264_nal(dec, nal, len(nal), ctypes.byref(got), msg,
                                  _MSG)
        if rc:
            _status(rc, msg, self.path, "h264.cpp")
        return bool(got.value)

    def _h264_end(self, dec) -> None:
        msg = ctypes.create_string_buffer(_MSG)
        rc = _get_h264().h264_end(dec, msg, _MSG)
        if rc:
            _status(rc, msg, self.path, "h264.cpp")

    def _open_h264(self) -> None:
        # every header first: a refused form raises before any frame
        lib = _get_h264()
        self._stream = _H264Stream(self.track)
        dec = lib.h264_open(1)
        try:
            for nal in self._stream.units():
                self._h264_nal(dec, nal)
            self._h264_end(dec)
            info = np.zeros(5, np.int32)
            lib.h264_info(dec, info.ctypes.data)
        finally:
            lib.h264_close(dec)
        if not info[4]:
            raise VideoOpenError(f"{self.path}: no H.264 picture")
        self.width, self.height = int(info[0]), int(info[1])

    def _h264_planes(self) -> Iterator[np.ndarray]:
        lib = _get_h264()
        w, h = self.width, self.height
        cw, ch = (w + 1) // 2, (h + 1) // 2
        self.close()
        self._dec = lib.h264_open(0)
        t0 = time.perf_counter()
        info = np.zeros(5, np.int32)
        for nal in self._stream.units():
            if not self._h264_nal(self._dec, nal):
                continue
            out = np.empty(w * h + 2 * cw * ch, np.uint8)
            lib.h264_planes(self._dec, out.ctypes.data)
            lib.h264_info(self._dec, info.ctypes.data)
            self._colour = (bool(info[2]), int(info[3]))
            self.seconds += time.perf_counter() - t0
            yield out
            t0 = time.perf_counter()
        self._h264_end(self._dec)

    def _feed(self, data: bytes) -> bool:
        msg = ctypes.create_string_buffer(_MSG)
        got = ctypes.c_int()
        rc = _get_lib().m4v_decode(self._dec, data, len(data),
                                   ctypes.byref(got), msg, _MSG)
        if rc:
            _status(rc, msg, self.path)
        return bool(got.value)

    def _open_mjpeg(self) -> None:
        if not self.track.frame_count:
            raise VideoOpenError(f"{self.path}: no frames")
        first = next(self.track.samples())
        self.width, self.height = self._mjpeg_dims(first)

    def _mjpeg_dims(self, data: bytes) -> Tuple[int, int]:
        dims = np.zeros(2, np.int32)
        msg = ctypes.create_string_buffer(_MSG)
        rc = image_io._get_lib().jpeg_decode_yuv420(
            data, len(data), None, 0, dims.ctypes.data, msg, _MSG)
        _status(rc, msg, self.path)
        return int(dims[0]), int(dims[1])

    def _mjpeg_planes(self, data: bytes):
        a = data.find(b"AVI1")
        if 0 <= a < 64 and len(data) > a + 4 and data[a + 4]:
            raise NotImplementedError(
                f"{self.path}: interlaced (two-field) MJPEG ({ITEM})")
        w, h = self.width, self.height
        cw, ch = (w + 1) // 2, (h + 1) // 2
        out = np.empty(w * h + 2 * cw * ch, np.uint8)
        dims = np.zeros(2, np.int32)
        msg = ctypes.create_string_buffer(_MSG)
        rc = image_io._get_lib().jpeg_decode_yuv420(
            data, len(data), out.ctypes.data, out.nbytes, dims.ctypes.data,
            msg, _MSG)
        _status(rc, msg, self.path)
        if (int(dims[0]), int(dims[1])) != (w, h):
            raise NotImplementedError(
                f"{self.path}: MJPEG frames of changing size ({ITEM})")
        return out

    def planes(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The decoded (Y, U, V) planes of each frame, 4:2:0."""
        w, h = self.width, self.height
        cw, ch = (w + 1) // 2, (h + 1) // 2
        if self.track.codec == "h264":
            for out in self._h264_planes():
                yield (out[:w * h].reshape(h, w),
                       out[w * h:w * h + cw * ch].reshape(ch, cw),
                       out[w * h + cw * ch:].reshape(ch, cw))
            return
        for data in self.track.samples():
            t0 = time.perf_counter()
            if self._dec is not None:
                if not self._feed(data):
                    continue
                out = np.empty(w * h + 2 * cw * ch, np.uint8)
                _get_lib().m4v_planes(self._dec, out.ctypes.data)
            else:
                out = self._mjpeg_planes(data)
            self.seconds += time.perf_counter() - t0
            yield (out[:w * h].reshape(h, w),
                   out[w * h:w * h + cw * ch].reshape(ch, cw),
                   out[w * h + cw * ch:].reshape(ch, cw))

    def __iter__(self) -> Iterator[np.ndarray]:
        for y, u, v in self.planes():
            t0 = time.perf_counter()
            rgb = yuv_to_rgb(y, u, v, *self._colour)
            self.seconds += time.perf_counter() - t0
            yield rgb

    def tools(self) -> dict:
        """How often each tool was decoded so far: MPEG-4's of
        :data:`TOOLS` (all 0 for MJPEG), H.264's of :data:`H264_TOOLS`."""
        h264 = self.track.codec == "h264"
        names = H264_TOOLS if h264 else TOOLS
        out = np.zeros(len(names), np.int64)
        if self._dec is not None:
            if h264:
                _get_h264().h264_tools(self._dec, out.ctypes.data, len(names))
            else:
                _get_lib().m4v_tools(self._dec, out.ctypes.data, len(names))
        return dict(zip(names, out.tolist()))

    def close(self) -> None:
        if self._dec is not None:
            if self.track.codec == "h264":
                _get_h264().h264_close(self._dec)
            else:
                _get_lib().m4v_close(self._dec)
            self._dec = None

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


class VideoWriter:
    """``write(rgb)`` frames of (height, width, 3) uint8 into an MPEG-4
    Part 2 ``.mp4``/``.m4v``/``.mov`` or ``.avi`` at ``fps``; ``close()``
    finishes the file.  ``seconds`` sums the time spent encoding."""

    def __init__(self, path: str, fps: float, size: Tuple[int, int]):
        ext = os.path.splitext(path)[1].lower()
        if ext not in MP4_EXTS + AVI_EXTS:
            raise NotImplementedError(
                f"{path}: the port writes .mp4/.m4v/.mov and .avi video "
                f"({ITEM})")
        self.path = path
        self.size = (int(size[0]), int(size[1]))
        self.width, self.height = self.size[0] & ~1, self.size[1] & ~1
        self.rate = frame_rate(float(fps))
        self.frames = 0
        self.seconds = 0.0
        lib = _get_lib()
        msg = ctypes.create_string_buffer(_MSG)
        self._enc = lib.m4v_enc_open(self.width, self.height, QUANT, GOP,
                                     self.rate.numerator,
                                     self.rate.denominator, msg, _MSG)
        if not self._enc:
            raise ValueError(f"{path}: {msg.value.decode()}")
        hdr = np.empty(256, np.uint8)
        n = lib.m4v_enc_header(self._enc, hdr.ctypes.data, hdr.nbytes)
        self._header = hdr[:n].tobytes()
        if ext in MP4_EXTS:
            self._mux = Mp4Writer(path, self.width, self.height, self.rate,
                                  self._header)
        else:
            self._mux = AviWriter(path, self.width, self.height, self.rate)
        self._inline = ext in AVI_EXTS
        self._buf = np.empty(self.width * self.height * 3 + 4096, np.uint8)

    def write(self, rgb: np.ndarray) -> None:
        rgb = np.asarray(rgb)
        w, h = self.size
        if rgb.shape != (h, w, 3) or rgb.dtype != np.uint8:
            raise ValueError(f"{self.path}: frames must be ({h}, {w}, 3) "
                             f"uint8, got {rgb.shape} {rgb.dtype}")
        t0 = time.perf_counter()
        w2, h2 = self.width, self.height
        rgb = np.ascontiguousarray(rgb[:h2, :w2])
        y = np.empty((h2, w2), np.uint8)
        u = np.empty((h2 // 2, w2 // 2), np.uint8)
        v = np.empty_like(u)
        lib = _get_lib()
        lib.rgb_to_yuv420(rgb.ctypes.data, w2, h2, y.ctypes.data,
                          u.ctypes.data, v.ctypes.data)
        key = ctypes.c_int()
        msg = ctypes.create_string_buffer(_MSG)
        n = lib.m4v_enc_frame(self._enc, y.ctypes.data, u.ctypes.data,
                              v.ctypes.data, self._buf.ctypes.data,
                              self._buf.nbytes, ctypes.byref(key), msg, _MSG)
        if not n:
            raise ValueError(f"{self.path}: {msg.value.decode()}")
        if n > self._buf.nbytes:
            raise ValueError(f"{self.path}: a VOP of {n} bytes")
        data = self._buf[:n].tobytes()
        if self._inline and not self.frames:
            data = self._header + data
        self._mux.add(data, bool(key.value))
        self.frames += 1
        self.seconds += time.perf_counter() - t0

    def close(self) -> None:
        if self._enc is not None:
            self._mux.close()
            _get_lib().m4v_enc_close(self._enc)
            self._enc = None

    def __enter__(self) -> "VideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
