"""Video containers read and written without OpenCV: ISO BMFF (``.mp4``,
``.m4v``, ``.mov``) and RIFF AVI, holding MPEG-4 Part 2 (``mp4v``), MJPEG
or H.264 frames, and raw H.264 Annex B files (``.h264``, ``.264``).

Reading finds the first video track and its samples (offset, size and
whether it is a key frame), its codec configuration (the MPEG-4 VOL an
``.mp4`` keeps in ``esds``, H.264's ``avcC``; an ``.avi`` carries either
inline) and its frame rate and frame count as ``cv2.VideoCapture``
reports them (the stream's average rate: frames over duration in
``.mp4``, ``dwRate / dwScale`` in ``.avi``; a raw H.264 file has FFmpeg's
default 25 fps and no duration, which OpenCV turns into the frame count
of :data:`RAW_FRAME_COUNT`).  A track in another codec (HEVC, ...), a
``ctts`` box (an output order other than decoding order), an edit list
that does not span the whole track, an OpenDML ``AVIX`` extension and
other containers (Matroska, WebM) raise ``NotImplementedError``
(ROADMAP.md, queue A item 19); a file that holds no readable video track
(cut before its ``moov``, not a container) raises
:class:`VideoOpenError`.

Writing repeats what FFmpeg's muxers write for ``cv2.VideoWriter``: an
``.mp4`` of ``ftyp``, ``mdat`` and a ``moov`` at the end (the VOL in
``esds``, ``stss`` for the key frames, ``co64`` past 4 GiB, the media
timescale FFmpeg's ``mov`` muxer picks: the rate's denominator doubled
until it reaches 10,000, so 29.97 fps is 11,988 with 400 a frame); an
``.avi`` of ``hdrl``, ``movi`` with ``00dc`` chunks and ``idx1``, which
refuses to grow past 1 GiB (an OpenDML file is not written).
"""

from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass
from fractions import Fraction
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

ITEM = "ROADMAP.md, queue A item 19"
MP4_EXTS = (".mp4", ".m4v", ".mov")
AVI_EXTS = (".avi",)
# sample-entry and AVI fourccs of the two codecs the port decodes
_MP4V_ENTRIES = (b"mp4v",)
_MJPEG_ENTRIES = (b"jpeg", b"mjpa")
_MP4V_FOURCCS = (b"FMP4", b"XVID", b"DIVX", b"DX50", b"MP4V", b"mp4v",
                 b"fmp4", b"xvid", b"divx", b"dx50")
_MJPEG_FOURCCS = (b"MJPG", b"mjpg")
_H264_ENTRIES = (b"avc1", b"avc3")
_H264_FOURCCS = (b"H264", b"X264", b"h264", b"x264", b"avc1")
H264_EXTS = (".h264", ".264")
_AVI_MAX = 1 << 30
_RAW_CHUNK = 1 << 20
# FFmpeg's raw H.264 demuxer: 25 fps, a 1/1200000 time base and no
# duration (AV_NOPTS_VALUE), which OpenCV's frame count multiplies out
RAW_FPS = 25.0
RAW_FRAME_COUNT = int(math.floor(-(2 ** 63) / 1200000.0 * RAW_FPS + 0.5))


class VideoOpenError(ValueError):
    """The file holds no video track this module can find."""


def _refuse(what: str):
    raise NotImplementedError(
        f"{what}: the port reads MPEG-4 Part 2 (mp4v), MJPEG and H.264 video "
        f"in .mp4/.mov and .avi files and raw H.264 ({ITEM})")


@dataclass
class VideoTrack:
    """The first video track of a file."""

    path: str
    container: str               # "mp4" | "avi" | "h264" (raw Annex B)
    codec: str                   # "mp4v" | "mjpeg" | "h264"
    fourcc: str                  # sample entry (.mp4) or strh handler (.avi)
    width: int
    height: int
    fps: float
    offsets: np.ndarray          # int64 byte offset of each sample
    sizes: np.ndarray            # int64 byte size of each sample
    keyframes: np.ndarray        # bool, one a sample
    config: bytes = b""          # decoder configuration (VOL, avcC), if any
    count: Optional[int] = None  # the frame count cv2 reports, if not
                                 # the number of samples

    @property
    def frame_count(self) -> int:
        return int(len(self.sizes)) if self.count is None else self.count

    def samples(self, head: int = 0) -> Iterator[bytes]:
        """Each sample's bytes (only the first ``head`` of each, if set)."""
        with open(self.path, "rb") as f:
            for off, n in zip(self.offsets.tolist(), self.sizes.tolist()):
                n = min(n, head) if head else n
                f.seek(off)
                data = f.read(n)
                if len(data) != n:
                    raise VideoOpenError(
                        f"{self.path}: sample at {off} is cut short")
                yield data


def open_track(path: str) -> VideoTrack:
    """The first video track of ``path`` (.mp4/.m4v/.mov or .avi)."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError as e:
        raise VideoOpenError(f"{path}: {e}") from None
    if len(head) >= 12 and head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return _open_avi(path)
    if len(head) >= 8 and head[4:8] in (b"ftyp", b"moov", b"mdat", b"free",
                                        b"wide", b"skip", b"pnot"):
        return _open_mp4(path)
    if head[:4] == b"\x1a\x45\xdf\xa3":
        _refuse(f"{path}: Matroska/WebM")
    if (os.path.splitext(path)[1].lower() in H264_EXTS
            and (head[:4] == b"\0\0\0\1" or head[:3] == b"\0\0\1")):
        return _open_annexb(path)
    raise VideoOpenError(f"{path}: not an MP4/MOV, AVI or H.264 file")


def _open_annexb(path: str) -> VideoTrack:
    """A raw Annex B file: its bytes as chunks of a stream (the reader
    splits them into NAL units)."""
    size = os.path.getsize(path)
    offsets = np.arange(0, size, _RAW_CHUNK, dtype=np.int64)
    sizes = np.minimum(size - offsets, _RAW_CHUNK)
    keys = np.zeros(len(offsets), bool)
    return VideoTrack(path, "h264", "h264", "", 0, 0, RAW_FPS, offsets,
                      sizes, keys, count=RAW_FRAME_COUNT)


# ---------------------------------------------------------------- ISO BMFF

def _boxes(f: BinaryIO, start: int,
           end: int) -> Iterator[Tuple[bytes, int, int]]:
    """(type, body offset, body end) of the boxes in [start, end)."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        hdr = f.read(16)
        if len(hdr) < 8:
            return
        size, typ = struct.unpack(">I4s", hdr[:8])
        body = pos + 8
        if size == 1:
            if len(hdr) < 16:
                return
            size = struct.unpack(">Q", hdr[8:16])[0]
            body = pos + 16
        elif size == 0:
            size = end - pos
        if size < body - pos:
            raise VideoOpenError(f"box {typ!r} at {pos} has size {size}")
        yield typ, body, min(pos + size, end)
        pos += size


def _read(f: BinaryIO, start: int, end: int) -> bytes:
    f.seek(start)
    data = f.read(end - start)
    if len(data) != end - start:
        raise VideoOpenError("box cut short")
    return data


def _descriptor(b: bytes, pos: int) -> Tuple[int, int, int]:
    """(tag, body start, body end) of an MPEG-4 systems descriptor."""
    tag = b[pos]
    pos += 1
    n = 0
    for _ in range(4):
        c = b[pos]
        pos += 1
        n = (n << 7) | (c & 0x7F)
        if not c & 0x80:
            break
    return tag, pos, pos + n


def _esds_config(b: bytes) -> bytes:
    """The DecoderSpecificInfo of an ``esds`` body (after version/flags)."""
    tag, p, end = _descriptor(b, 4)
    if tag != 3:
        raise VideoOpenError("esds without an ES_Descriptor")
    flags = b[p + 2]
    p += 3
    if flags & 0x80:
        p += 2
    if flags & 0x40:
        p += 1 + b[p]
    if flags & 0x20:
        p += 2
    tag, p, dend = _descriptor(b, p)
    if tag != 4:
        raise VideoOpenError("esds without a DecoderConfigDescriptor")
    if b[p] != 0x20:
        _refuse(f"esds object type 0x{b[p]:02x} (not MPEG-4 Visual)")
    p += 13
    if p < dend:
        tag, p, iend = _descriptor(b, p)
        if tag == 5:
            return b[p:iend]
    return b""


def _open_mp4(path: str) -> VideoTrack:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        fsize = f.tell()
        moov = [(s, e) for t, s, e in _boxes(f, 0, fsize) if t == b"moov"]
        if not moov:
            raise VideoOpenError(f"{path}: no moov box (file cut short?)")
        movie_ts = None
        for t, s, e in _boxes(f, *moov[0]):
            if t == b"mvhd":
                b = _read(f, s, min(e, s + 32))
                movie_ts = struct.unpack(">I", b[20:24] if b[0] == 1
                                         else b[12:16])[0]
            if t != b"trak":
                continue
            track = _mp4_track(f, path, s, e, movie_ts)
            if track is not None:
                return track
    raise VideoOpenError(f"{path}: no video track")


def _children(f, s, e):
    return {t: (bs, be) for t, bs, be in _boxes(f, s, e)}


def _mp4_track(f, path, s, e, movie_ts) -> Optional[VideoTrack]:
    trak = _children(f, s, e)
    if b"mdia" not in trak:
        return None
    mdia = _children(f, *trak[b"mdia"])
    hdlr = _read(f, *mdia[b"hdlr"]) if b"hdlr" in mdia else b""
    if hdlr[8:12] != b"vide":
        return None
    mdhd = _read(f, *mdia[b"mdhd"])
    if mdhd[0] == 1:
        timescale = struct.unpack(">I", mdhd[20:24])[0]
    else:
        timescale = struct.unpack(">I", mdhd[12:16])[0]
    stbl = _children(f, *_children(f, *mdia[b"minf"])[b"stbl"])
    stsd = _read(f, *stbl[b"stsd"])
    if struct.unpack(">I", stsd[4:8])[0] < 1:
        raise VideoOpenError(f"{path}: empty stsd")
    esize, entry = struct.unpack(">I4s", stsd[8:16])
    body = stsd[16:8 + esize]
    if entry in _MP4V_ENTRIES:
        codec = "mp4v"
    elif entry in _MJPEG_ENTRIES:
        codec = "mjpeg"
    elif entry in _H264_ENTRIES:
        codec = "h264"
    else:
        _refuse(f"{path}: video track in {entry.decode('latin-1')!r}")
    width, height = struct.unpack(">HH", body[24:28])
    config = b""
    for t, cs, ce in _boxes_bytes(body, 78):
        if t == b"esds" and codec == "mp4v":
            config = _esds_config(body[cs:ce])
        elif t == b"avcC" and codec == "h264":
            config = body[cs:ce]
    if codec == "h264" and not config:
        raise VideoOpenError(f"{path}: an {entry.decode()} entry without avcC")
    if b"ctts" in stbl:
        _refuse(f"{path}: a ctts box (pictures output in another order than "
                f"they are decoded: B frames)")
    # sample table
    n, sizes = _stsz(f, stbl, path)
    offsets = _chunk_offsets(f, stbl, n, sizes, path)
    stts = _read(f, *stbl[b"stts"])
    cnt = struct.unpack(">I", stts[4:8])[0]
    runs = np.frombuffer(stts, ">u4", cnt * 2, 8).reshape(-1, 2)
    runs = runs.astype(np.int64)
    frames = int(runs[:, 0].sum())
    duration = int((runs[:, 0] * runs[:, 1]).sum())
    if b"stss" in stbl:
        stss = _read(f, *stbl[b"stss"])
        cnt = struct.unpack(">I", stss[4:8])[0]
        keys = np.zeros(n, bool)
        idx = np.frombuffer(stss, ">u4", cnt, 8).astype(np.int64) - 1
        keys[idx[(idx >= 0) & (idx < n)]] = True
    else:
        keys = np.ones(n, bool)
    if b"edts" in trak:
        _check_edits(f, trak[b"edts"], movie_ts, timescale, duration, path)
    fps = float(Fraction(timescale * frames, duration)) if duration else 0.0
    return VideoTrack(path, "mp4", codec, entry.decode("latin-1"), width,
                      height, fps, offsets, sizes, keys, config)


def _boxes_bytes(b: bytes, pos: int) -> Iterator[Tuple[bytes, int, int]]:
    while pos + 8 <= len(b):
        size, typ = struct.unpack(">I4s", b[pos:pos + 8])
        if size < 8:
            return
        yield typ, pos + 8, pos + size
        pos += size


def _stsz(f, stbl, path) -> Tuple[int, np.ndarray]:
    if b"stsz" in stbl:
        b = _read(f, *stbl[b"stsz"])
        fixed, n = struct.unpack(">II", b[4:12])
        if fixed:
            return n, np.full(n, fixed, np.int64)
        return n, np.frombuffer(b, ">u4", n, 12).astype(np.int64)
    if b"stz2" in stbl:
        b = _read(f, *stbl[b"stz2"])
        bits, n = b[7], struct.unpack(">I", b[8:12])[0]
        if bits == 16:
            return n, np.frombuffer(b, ">u2", n, 12).astype(np.int64)
        if bits == 8:
            return n, np.frombuffer(b, "u1", n, 12).astype(np.int64)
        if bits == 4:
            v = np.frombuffer(b, "u1", (n + 1) // 2, 12)
            return n, np.stack([v >> 4, v & 15], 1).reshape(-1)[:n].astype(
                np.int64)
        raise VideoOpenError(f"{path}: stz2 field size {bits}")
    raise VideoOpenError(f"{path}: no sample sizes")


def _chunk_offsets(f, stbl, n, sizes, path) -> np.ndarray:
    if b"stco" in stbl:
        b = _read(f, *stbl[b"stco"])
        cnt = struct.unpack(">I", b[4:8])[0]
        chunks = np.frombuffer(b, ">u4", cnt, 8).astype(np.int64)
    elif b"co64" in stbl:
        b = _read(f, *stbl[b"co64"])
        cnt = struct.unpack(">I", b[4:8])[0]
        chunks = np.frombuffer(b, ">u8", cnt, 8).astype(np.int64)
    else:
        raise VideoOpenError(f"{path}: no chunk offsets")
    b = _read(f, *stbl[b"stsc"])
    cnt = struct.unpack(">I", b[4:8])[0]
    stsc = np.frombuffer(b, ">u4", cnt * 3, 8).reshape(-1, 3).astype(np.int64)
    offsets = np.zeros(n, np.int64)
    k = 0
    for i, (first, per, _) in enumerate(stsc.tolist()):
        last = stsc[i + 1, 0] - 1 if i + 1 < len(stsc) else len(chunks)
        for c in range(first - 1, last):
            if k >= n:
                break
            pos = int(chunks[c])
            for _ in range(per):
                if k >= n:
                    break
                offsets[k] = pos
                pos += int(sizes[k])
                k += 1
    if k != n:
        raise VideoOpenError(f"{path}: sample table covers {k} of {n} samples")
    return offsets


def _check_edits(f, edts, movie_ts, timescale, duration, path) -> None:
    for t, s, e in _boxes(f, *edts):
        if t != b"elst":
            continue
        b = _read(f, s, e)
        ver, cnt = b[0], struct.unpack(">I", b[4:8])[0]
        ents = []
        for i in range(cnt):
            if ver == 1:
                seg, mt = struct.unpack(">Qq", b[8 + 20 * i:24 + 20 * i])
                rate = struct.unpack(">i", b[24 + 20 * i:28 + 20 * i])[0]
            else:
                seg, mt = struct.unpack(">Ii", b[8 + 12 * i:16 + 12 * i])
                rate = struct.unpack(">i", b[16 + 12 * i:20 + 12 * i])[0]
            ents.append((seg, mt, rate))
        whole = (len(ents) == 1 and ents[0][1] == 0
                 and ents[0][2] == 0x10000 and movie_ts
                 and abs(ents[0][0] * timescale - duration * movie_ts)
                 <= max(timescale, movie_ts))
        if ents and not whole:
            _refuse(f"{path}: an edit list that does not span the track "
                    f"({ents})")


# --------------------------------------------------------------------- AVI

def _open_avi(path: str) -> VideoTrack:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        fsize = f.tell()
        riff_size = struct.unpack("<I", _read(f, 4, 8))[0]
        end = min(fsize, 8 + riff_size)
        if end + 12 <= fsize:
            f.seek(end + (end & 1))
            nxt = f.read(12)
            if nxt[:4] == b"RIFF" and nxt[8:12] == b"AVIX":
                _refuse(f"{path}: an OpenDML AVIX extension (file past 1 GiB)")
        hdrl = movi = idx1 = None
        for t, s, e in _riff(f, 12, end):
            if t == b"LIST":
                kind = _read(f, s, s + 4)
                if kind == b"hdrl":
                    hdrl = (s + 4, e)
                elif kind == b"movi":
                    movi = (s, e)
            elif t == b"idx1":
                idx1 = (s, e)
        if hdrl is None or movi is None:
            raise VideoOpenError(f"{path}: no hdrl or movi list")
        stream, info = 0, None
        for t, s, e in _riff(f, *hdrl):
            if t == b"LIST" and _read(f, s, s + 4) == b"strl":
                parts = {t2: (s2, e2) for t2, s2, e2 in _riff(f, s + 4, e)}
                strh = _read(f, *parts[b"strh"])
                if strh[:4] == b"vids":
                    info = (strh, _read(f, *parts[b"strf"]))
                    break
                stream += 1
        if info is None:
            raise VideoOpenError(f"{path}: no video stream")
        strh, strf = info
        handler, = struct.unpack("4s", strh[4:8])
        scale, rate = struct.unpack("<II", strh[20:28])
        width, height, _, _, compression = struct.unpack("<iiHH4s", strf[4:20])
        fourcc = compression if compression.strip(b"\0") else handler
        if fourcc in _MP4V_FOURCCS or handler in _MP4V_FOURCCS:
            codec = "mp4v"
        elif fourcc in _MJPEG_FOURCCS or handler in _MJPEG_FOURCCS:
            codec = "mjpeg"
        elif fourcc in _H264_FOURCCS or handler in _H264_FOURCCS:
            codec = "h264"
        else:
            _refuse(f"{path}: video stream in {fourcc.decode('latin-1')!r}")
        tag = b"%02d" % stream
        if idx1 is not None:
            offsets, sizes, keys = _avi_index(f, idx1, movi, tag)
        else:
            offsets, sizes, keys = _avi_scan(f, movi, tag)
        fps = float(Fraction(rate, scale)) if scale and rate else 0.0
        return VideoTrack(path, "avi", codec, fourcc.decode("latin-1"),
                          abs(width), abs(height), fps, offsets, sizes, keys)


def _riff(f, start: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        hdr = f.read(8)
        if len(hdr) < 8:
            return
        typ, size = struct.unpack("<4sI", hdr)
        yield typ, pos + 8, min(pos + 8 + size, end)
        pos += 8 + size + (size & 1)


def _avi_index(f, idx1, movi, tag):
    b = _read(f, *idx1)
    ents = np.frombuffer(b, np.dtype([("id", "S4"), ("flags", "<u4"),
                                      ("off", "<u4"), ("size", "<u4")]),
                         len(b) // 16)
    mine = ents[np.char.startswith(ents["id"], tag)
                & np.isin([i[2:] for i in ents["id"]], [b"dc", b"db"])]
    off = mine["off"].astype(np.int64)
    # idx1 offsets count from the 'movi' fourcc, or (some writers) from
    # the file's start: the first chunk's header shows which
    base = movi[0]
    if len(off) and _read(f, off[0] + base,
                          off[0] + base + 4) != mine["id"][0]:
        base = 0
    return (off + base + 8, mine["size"].astype(np.int64),
            (mine["flags"] & 0x10).astype(bool))


def _avi_scan(f, movi, tag):
    offs, sizes = [], []

    def walk(s, e):
        for t, cs, ce in _riff(f, s, e):
            if t == b"LIST":
                walk(cs + 4, ce)
            elif t[:2] == tag and t[2:] in (b"dc", b"db"):
                offs.append(cs)
                sizes.append(ce - cs)
    walk(movi[0] + 4, movi[1])
    keys = np.zeros(len(offs), bool)
    if len(keys):
        keys[0] = True
    return np.array(offs, np.int64), np.array(sizes, np.int64), keys


# ----------------------------------------------------------------- writing

def frame_rate(fps: float) -> Fraction:
    """The rational ``cv2.VideoWriter`` makes of ``fps``: the smallest
    power-of-ten denominator that holds it within 0.001."""
    num, den = int(fps + 0.5), 1
    while abs(num / den - fps) > 0.001:
        den *= 10
        num = int(fps * den + 0.5)
    return Fraction(num, den)


class Mp4Writer:
    """An MPEG-4 Part 2 track: ``ftyp``, ``mdat`` of the samples as they
    come, and ``moov`` at :meth:`close`."""

    def __init__(self, path: str, width: int, height: int, rate: Fraction,
                 config: bytes):
        self.path, self.width, self.height = path, width, height
        self.rate, self.config = rate, config
        # the mov muxer's timescale: the time base's denominator, doubled
        # up to 10,000
        self.timescale = rate.numerator
        while self.timescale < 10000:
            self.timescale *= 2
        self.delta = self.timescale * rate.denominator // rate.numerator
        self.offsets: List[int] = []
        self.sizes: List[int] = []
        self.keys: List[int] = []
        self.f = open(path, "wb")
        self.f.write(_box(b"ftyp", b"isom\0\0\x02\0isomiso2mp41"))
        self.f.write(_box(b"free", b""))
        self.mdat = self.f.tell()
        self.f.write(struct.pack(">I4sQ", 1, b"mdat", 0))

    def add(self, data: bytes, key: bool) -> None:
        if key:
            self.keys.append(len(self.sizes) + 1)
        self.offsets.append(self.f.tell())
        self.sizes.append(len(data))
        self.f.write(data)

    def close(self) -> None:
        if self.f is None:
            return
        end = self.f.tell()
        self.f.seek(self.mdat + 8)
        self.f.write(struct.pack(">Q", end - self.mdat))
        self.f.seek(end)
        self.f.write(self._moov())
        self.f.close()
        self.f = None

    def _moov(self) -> bytes:
        n = len(self.sizes)
        dur = n * self.delta
        mdur = dur * 1000 // self.timescale
        matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                             0x40000000)
        mvhd = _full(b"mvhd", 0, struct.pack(">IIII", 0, 0, 1000, mdur)
                     + struct.pack(">IH10x", 0x10000, 0x100) + matrix
                     + b"\0" * 24 + struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 3, struct.pack(">IIIII", 0, 0, 1, 0, mdur)
                     + b"\0" * 8 + struct.pack(">hhH2x", 0, 0, 0) + matrix
                     + struct.pack(">II", self.width << 16,
                                   self.height << 16))
        elst = _full(b"elst", 0, struct.pack(">IIiI", 1, mdur, 0, 0x10000))
        mdhd = _full(b"mdhd", 0, struct.pack(">IIIIHH", 0, 0, self.timescale,
                                             dur, 0x55C4, 0))
        hdlr = _full(b"hdlr", 0, b"\0" * 4 + b"vide" + b"\0" * 12
                     + b"VideoHandler\0")
        vmhd = _full(b"vmhd", 1, b"\0" * 8)
        dinf = _box(b"dinf", _full(b"dref", 0, struct.pack(">I", 1)
                                   + _full(b"url ", 1, b"")))
        entry = _visual_entry(b"mp4v", self.width, self.height,
                              _esds(self.config))
        stsd = _full(b"stsd", 0, struct.pack(">I", 1) + entry)
        stts = _full(b"stts", 0, struct.pack(">III", 1, n, self.delta))
        stss = _full(b"stss", 0, struct.pack(f">I{len(self.keys)}I",
                                             len(self.keys), *self.keys))
        stsc = _full(b"stsc", 0, struct.pack(">IIII", 1, 1, 1, 1))
        stsz = _full(b"stsz", 0, struct.pack(f">II{n}I", 0, n, *self.sizes))
        if self.offsets and self.offsets[-1] >= 1 << 32:
            stco = _full(b"co64", 0, struct.pack(f">I{n}Q", n, *self.offsets))
        else:
            stco = _full(b"stco", 0, struct.pack(f">I{n}I", n, *self.offsets))
        stbl = _box(b"stbl", stsd + stts + stss + stsc + stsz + stco)
        minf = _box(b"minf", vmhd + dinf + stbl)
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        trak = _box(b"trak", tkhd + _box(b"edts", elst) + mdia)
        return _box(b"moov", mvhd + trak)


def _box(typ: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), typ) + body


def _full(typ: bytes, flags: int, body: bytes) -> bytes:
    return _box(typ, struct.pack(">I", flags) + body)


def _visual_entry(typ: bytes, w: int, h: int, children: bytes) -> bytes:
    body = (b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16
            + struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1)
            + b"\0" * 32 + struct.pack(">Hh", 24, -1) + children)
    return _box(typ, body)


def _desc(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


def _esds(config: bytes) -> bytes:
    dsi = _desc(5, config)
    dcd = _desc(4, bytes([0x20, 0x11]) + b"\0" * 11 + dsi)
    es = _desc(3, struct.pack(">HB", 1, 0) + dcd + _desc(6, b"\x02"))
    return _full(b"esds", 0, es)


class AviWriter:
    """``RIFF AVI `` with one video stream: ``hdrl``, ``movi`` of ``00dc``
    chunks and ``idx1``.  A file past 1 GiB would need OpenDML and is
    refused."""

    def __init__(self, path: str, width: int, height: int, rate: Fraction,
                 fourcc: bytes = b"FMP4"):
        self.path, self.width, self.height = path, width, height
        self.rate, self.fourcc = rate, fourcc
        self.index: List[Tuple[int, int, int]] = []
        self.f = open(path, "wb")
        self.f.write(self._header(0, 0))
        self.movi = self.f.tell() - 4

    def _header(self, frames: int, largest: int) -> bytes:
        r = self.rate
        avih = _chunk(b"avih", struct.pack(
            "<14I", 1000000 * r.denominator // r.numerator, 0, 0, 0x10,
            frames, 0, 1, largest, self.width, self.height, 0, 0, 0, 0))
        strh = _chunk(b"strh", struct.pack(
            "<4s4sIHHIIIIIIIIhhhh", b"vids", self.fourcc, 0, 0, 0, 0,
            r.denominator, r.numerator, 0, frames, largest, 0xFFFFFFFF, 0,
            0, 0, self.width, self.height))
        strf = _chunk(b"strf", struct.pack(
            "<IiiHH4sIiiII", 40, self.width, self.height, 1, 24,
            self.fourcc, self.width * self.height * 3, 0, 0, 0, 0))
        strl = _list(b"strl", strh + strf)
        hdrl = _list(b"hdrl", avih + strl)
        return (struct.pack("<4sI4s", b"RIFF", 0, b"AVI ") + hdrl
                + struct.pack("<4sI4s", b"LIST", 0, b"movi"))

    def add(self, data: bytes, key: bool) -> None:
        pos = self.f.tell()
        if pos + len(data) + 16 * (len(self.index) + 2) > _AVI_MAX:
            raise NotImplementedError(
                f"{self.path}: an AVI past 1 GiB needs an OpenDML extension, "
                f"which the port does not write ({ITEM})")
        self.index.append((pos - self.movi, len(data), 0x10 if key else 0))
        self.f.write(_chunk(b"00dc", data))

    def close(self) -> None:
        if self.f is None:
            return
        movi_end = self.f.tell()
        idx = b"".join(struct.pack("<4sIII", b"00dc", flags, off, n)
                       for off, n, flags in self.index)
        self.f.write(_chunk(b"idx1", idx))
        end = self.f.tell()
        largest = max((n for _, n, _ in self.index), default=0)
        self.f.seek(0)
        self.f.write(self._header(len(self.index), largest))
        self.f.seek(4)
        self.f.write(struct.pack("<I", end - 8))
        self.f.seek(self.movi - 4)
        self.f.write(struct.pack("<I", movi_end - self.movi))
        self.f.close()
        self.f = None


def _chunk(typ: bytes, body: bytes) -> bytes:
    return struct.pack("<4sI", typ, len(body)) + body + b"\0" * (len(body) & 1)


def _list(kind: bytes, body: bytes) -> bytes:
    return struct.pack("<4sI4s", b"LIST", 4 + len(body), kind) + body
