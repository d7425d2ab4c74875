"""A test-side H.264 stream writer, numpy only: seeded streams whose syntax
is chosen at random per macroblock, in Annex B, MP4 (``avc1`` + ``avcC``,
``avc3``) and AVI, for ``tests/test_torch_h264.py`` and ``chip_smoke.py``.

It writes syntax, not pictures: slice and macroblock types, intra modes,
motion vector differences, reference indices, weights and coefficient
levels are drawn at random within what the standard allows (intra modes
only from available samples, reference indices only to pictures that
exist, coefficients small enough that no 16-bit intermediate overflows),
and both entropy coders (CAVLC and CABAC, with the context modelling of
the I and P syntax) turn them into bits.  The decoded frames are whatever
that syntax decodes to: ``cv2.VideoCapture`` is the reference.

The code tables (CAVLC codes, CABAC initialisation and state tables, the
8x8 context maps, scans, default matrices) are read from the port's
decoder, ``glsdet_tpu_torch/native/h264.cpp``; an error there shows as a
stream cv2 decodes otherwise.

``write_clip(path, Spec(...))`` writes a file by its extension (``.264``
or ``.h264``: Annex B; ``.mp4``/``.mov``: ``Spec.entry`` avc1 or avc3;
``.avi``: fourcc ``Spec.fourcc``) and returns the access units.
"""

from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "glsdet_tpu_torch", "native", "h264.cpp")
_TABLES: Dict[str, np.ndarray] = {}


def table(name: str) -> np.ndarray:
    """The integers of ``static const int <name>[...] = {...};`` in the
    decoder's source, flat."""
    if not _TABLES:
        src = open(_SRC).read()
        for m in re.finditer(
                r"static const int (\w+)((?:\[\d+\])+) = \{(.*?)\};", src,
                re.S):
            body = re.sub(r"//[^\n]*", "", m.group(3))
            _TABLES[m.group(1)] = np.array(
                [int(v) for v in re.findall(r"-?\d+", body)], np.int64)
    return _TABLES[name]


ZZ4 = table("kZigzag4").tolist()
ZZ8 = table("kZigzag8").tolist()
BLK_X = table("kBlkX").tolist()
BLK_Y = table("kBlkY").tolist()
BLK_AT = table("kBlkAt").reshape(4, 4).tolist()
CHROMA_QP = table("kChromaQp").tolist()


def _padded(name, rows, width):
    """A C table of rows written with fewer initialisers than ``width``."""
    src = open(_SRC).read()
    m = re.search(r"static const int %s\[[^=]*= \{(.*?)\};" % name, src, re.S)
    body = re.sub(r"//[^\n]*", "", m.group(1))
    out = []
    for r in re.findall(r"\{([^{}]*)\}", body):
        v = [int(x) for x in re.findall(r"-?\d+", r)]
        out.append(v + [0] * (width - len(v)))
    assert len(out) == rows, name
    return out


CT_LEN = table("kCoeffTokenLen").reshape(3, 68).tolist()
CT_BITS = table("kCoeffTokenBits").reshape(3, 68).tolist()
CDC_LEN = table("kChromaDcTokenLen").tolist()
CDC_BITS = table("kChromaDcTokenBits").tolist()
TZ_LEN = _padded("kTotalZerosLen", 15, 16)
TZ_BITS = _padded("kTotalZerosBits", 15, 16)
CTZ_LEN = _padded("kChromaDcTotalZerosLen", 3, 4)
CTZ_BITS = _padded("kChromaDcTotalZerosBits", 3, 4)
RUN_LEN = _padded("kRunLen", 7, 16)
RUN_BITS = _padded("kRunBits", 7, 16)
INTRA_CBP = {c: i for i, c in enumerate(table("kIntraCbp").tolist())}
INTER_CBP = {c: i for i, c in enumerate(table("kInterCbp").tolist())}
CABAC_INIT = table("kCabacInit").reshape(4, 460, 2)
RANGE_LPS = table("kRangeLps").reshape(64, 4).tolist()
TRANS_LPS = table("kTransIdxLps").tolist()
SIG8 = table("kSig8x8").tolist()
LAST8 = table("kLast8x8").tolist()
DEF4 = table("kDefault4").reshape(2, 16)
DEF8 = table("kDefault8").reshape(2, 64)
NORM4 = table("kNormAdjust4").reshape(6, 3)
NORM8 = table("kNormAdjust8").reshape(6, 6)


def _norm4(m, i):
    x, y = i & 3, i >> 2
    if not x & 1 and not y & 1:
        return NORM4[m][0]
    return NORM4[m][1] if x & 1 and y & 1 else NORM4[m][2]


def _norm8(m, i):
    x, y = i & 7, i >> 3
    if not x & 3 and not y & 3:
        return NORM8[m][0]
    if x & 1 and y & 1:
        return NORM8[m][1]
    if x & 3 == 2 and y & 3 == 2:
        return NORM8[m][2]
    if (not y & 3 and x & 1) or (y & 1 and not x & 3):
        return NORM8[m][3]
    if (not y & 3 and x & 3 == 2) or (y & 3 == 2 and not x & 3):
        return NORM8[m][4]
    return NORM8[m][5]


# ------------------------------------------------------------------ bits

class BitWriter:
    def __init__(self):
        self.parts: List[str] = []
        self.n = 0

    def u(self, n, v):
        if n:
            assert 0 <= v < (1 << n), (n, v)
            self.parts.append(format(v, "0%db" % n))
            self.n += n

    def bit(self, b):
        self.parts.append("1" if b else "0")
        self.n += 1

    def ue(self, v):
        v += 1
        n = v.bit_length()
        self.parts.append("0" * (n - 1) + format(v, "b"))
        self.n += 2 * n - 1

    def se(self, v):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def te(self, rng, v):
        if rng == 1:
            self.bit(not v)
        else:
            self.ue(v)

    def align(self, bit=0):
        k = (-self.n) % 8
        self.parts.append(str(bit) * k)
        self.n += k

    def trailing(self):
        self.bit(1)
        self.align()

    def bytes(self) -> bytes:
        s = "".join(self.parts)
        assert len(s) % 8 == 0
        return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


def nal_unit(ref_idc: int, typ: int, rbsp: bytes) -> bytes:
    """The NAL unit of ``rbsp`` with emulation prevention."""
    out = bytearray([(ref_idc << 5) | typ])
    zeros = 0
    for c in rbsp:
        if zeros >= 2 and c <= 3:
            out.append(3)
            zeros = 0
        out.append(c)
        zeros = zeros + 1 if c == 0 else 0
    return bytes(out)


class CabacEncoder:
    """The arithmetic encoder of 9.3.4.2 writing into a BitWriter."""

    def __init__(self, w: BitWriter):
        self.w = w
        self.reset()

    def reset(self):
        self.low, self.range, self.outstanding, self.first = 0, 510, 0, True

    def init_contexts(self, table_idx, qp):
        qp = min(max(qp, 0), 51)
        mn = CABAC_INIT[table_idx]
        self.state = []
        for m, n in mn.tolist():
            pre = min(max(((m * qp) >> 4) + n, 1), 126)
            self.state.append([63 - pre, 0] if pre <= 63 else [pre - 64, 1])

    def _put(self, b):
        if self.first:
            self.first = False
        else:
            self.w.bit(b)
        while self.outstanding:
            self.w.bit(1 - b)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx, b):
        st = self.state[ctx]
        s, mps = st
        lps = RANGE_LPS[s][(self.range >> 6) & 3]
        self.range -= lps
        if b != mps:
            self.low += self.range
            self.range = lps
            if s == 0:
                st[1] = 1 - mps
            st[0] = TRANS_LPS[s]
        else:
            st[0] = min(s + 1, 62)
        self._renorm()

    def bypass(self, b):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, b):
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.w.u(2, ((self.low >> 7) & 3) | 1)
        else:
            self._renorm()


# ---------------------------------------------------------- stream spec

@dataclass
class Spec:
    """What a clip exercises; every choice inside is drawn from ``seed``."""

    width: int = 64
    height: int = 48
    frames: int = 6
    seed: int = 0
    entropy: str = "cavlc"        # cavlc | cabac | mixed (PPSs of both)
    profile: int = 100            # 66 Baseline, 77 Main, 100 High
    poc_types: Tuple[int, ...] = (0,)   # one per SPS (cycled at IDRs)
    idr_every: int = 0            # an IDR every n pictures (0: only the first)
    i_every: int = 0              # a non-IDR I picture every n (0: none)
    slices: int = 1               # up to this many slices a picture
    refs: int = 1                 # max_num_ref_frames
    weighted: bool = False
    scaling: str = "none"         # none | sps | pps | both
    t8: bool = False              # transform_8x8_mode_flag
    constrained: bool = False
    deblock: Tuple[int, ...] = (0,)   # disable_deblocking_filter_idc drawn
    full_range: Optional[bool] = None  # None: no video_signal_type in VUI
    matrix: Optional[int] = None       # matrix_coefficients, if described
    crop: Tuple[int, int, int, int] = (0, 0, 0, 0)  # extra l, r, t, b
    nonref: float = 0.0           # share of P pictures with nal_ref_idc 0
    pcm: float = 0.02             # share of I_PCM macroblocks
    listmod: bool = False
    escapes: bool = False         # large levels (CAVLC level_prefix >= 14)
    qp: Tuple[int, int] = (18, 38)
    fps: float = 25.0
    entry: str = "avc1"           # mp4 sample entry: avc1 | avc3
    fourcc: str = "H264"          # avi fourcc
    skip: float = 0.3             # share of P_Skip in P slices
    coded: float = 1.0            # scales the share of macroblocks with
                                  # a coded_block_pattern
    change_pps: bool = False      # new PPS contents between pictures
    extra_nals: bool = False      # AUD, SEI and filler units
    # forms the port refuses (ROADMAP item 19), each written once: see
    # FORMS
    forms: Tuple[str, ...] = ()


# syntax each form puts into an otherwise valid stream
FORMS = {
    "b_slice": "picture 1's slices are B slices (slice_type 1)",
    "sp_slice": "picture 1's slices are SP slices (slice_type 3)",
    "si_slice": "picture 1's slices are SI slices (slice_type 4)",
    "ctts": "an .mp4 with a ctts box",
    "poc_order": "pictures 1 and 2 swap their POC (output order)",
    "interlace": "frame_mbs_only_flag 0 (MBAFF)",
    "fmo": "num_slice_groups_minus1 1",
    "redundant": "redundant_pic_cnt_present_flag 1",
    "chroma422": "chroma_format_idc 2",
    "bit_depth": "bit_depth_luma_minus8 2",
    "lossless": "qpprime_y_zero_transform_bypass_flag 1",
    "mmco": "adaptive_ref_pic_marking_mode_flag 1 in picture 2",
    "long_term": "long_term_reference_flag 1 in the IDR picture",
    "long_term_list": "a long-term entry in ref_pic_list_modification",
    "gaps": "gaps_in_frame_num_value_allowed_flag 1",
    "partitions": "a slice data partition A NAL unit (type 2)",
    "left_crop": "a left frame crop of 2 samples",
    "bt2020cl": "matrix_coefficients 10 (BT.2020 constant luminance)",
}


# ---------------------------------------------------------- writer state

class _Sps:
    def __init__(self, rs, spec: Spec, sps_id: int, poc_type: int):
        self.id = sps_id
        self.profile = spec.profile
        crop = spec.crop
        if "left_crop" in spec.forms:
            crop = (2,) + crop[1:]
        self.mb_w = -(-(spec.width + crop[0] + crop[1]) // 16)
        self.mb_h = -(-(spec.height + crop[2] + crop[3]) // 16)
        cw = 16 * self.mb_w - spec.width
        ch = 16 * self.mb_h - spec.height
        l, t = crop[0], crop[2]
        self.crop = (l, cw - l, t, ch - t)
        assert all(c % 2 == 0 and c >= 0 for c in self.crop), self.crop
        self.log2_max_fn = int(rs.choice([4, 5, 8]))
        self.poc_type = poc_type
        self.log2_max_lsb = int(rs.choice([4, 6, 8]))
        self.max_refs = spec.refs
        # delta_pic_order_always_zero only where no non-reference picture
        # would take a POC below its predecessor's
        self.always_zero = bool(rs.rand() < 0.5) and spec.nonref == 0
        self.cycle = [int(v) for v in rs.randint(2, 6, rs.randint(1, 4))]
        self.offset_nonref = -1
        self.offset_t2b = 0
        self.full_range, self.matrix = spec.full_range, spec.matrix
        self.forms = spec.forms
        if "bt2020cl" in spec.forms:
            self.full_range, self.matrix = False, 10
        self.scaling = None
        if spec.scaling in ("sps", "both") and spec.profile >= 100:
            self.scaling = _scaling_lists(rs, True, None, True)

    def rbsp(self) -> bytes:
        w = BitWriter()
        w.u(8, self.profile)
        w.u(8, 0)
        w.u(8, 40)
        w.ue(self.id)
        if self.profile >= 100:
            w.ue(2 if "chroma422" in self.forms else 1)
            w.ue(2 if "bit_depth" in self.forms else 0)
            w.ue(0)
            w.bit("lossless" in self.forms)
            w.bit(self.scaling is not None)
            if self.scaling is not None:
                _put_scaling(w, self.scaling["syntax"])
        w.ue(self.log2_max_fn - 4)
        w.ue(self.poc_type)
        if self.poc_type == 0:
            w.ue(self.log2_max_lsb - 4)
        elif self.poc_type == 1:
            w.bit(self.always_zero)
            w.se(self.offset_nonref)
            w.se(self.offset_t2b)
            w.ue(len(self.cycle))
            for v in self.cycle:
                w.se(v)
        w.ue(self.max_refs)
        w.bit("gaps" in self.forms)
        w.ue(self.mb_w - 1)
        w.ue(self.mb_h - 1)
        w.bit("interlace" not in self.forms)  # frame_mbs_only
        if "interlace" in self.forms:
            w.bit(1)  # mb_adaptive_frame_field_flag
        w.bit(1)  # direct_8x8_inference
        w.bit(any(self.crop))
        if any(self.crop):
            for c in self.crop:
                w.ue(c // 2)
        vui = self.full_range is not None
        w.bit(vui)
        if vui:
            w.bit(0)
            w.bit(0)
            w.bit(1)
            w.u(3, 5)
            w.bit(self.full_range)
            w.bit(self.matrix is not None)
            if self.matrix is not None:
                w.u(8, 2)
                w.u(8, 2)
                w.u(8, self.matrix)
            w.bit(0)  # chroma_loc
            w.bit(0)  # timing
            w.bit(0)
            w.bit(0)
            w.bit(0)  # pic_struct
            w.bit(0)  # bitstream_restriction
        w.trailing()
        return w.bytes()


def _scaling_lists(rs, is_sps, sps_lists, t8):
    """Random scaling_list() syntax (None: not present, "default": the
    default-matrix flag, else 16/64 values in scan order) and the lists it
    gives in raster order, by the fall-back rules."""
    syntax = []
    lists4, lists8 = [], []
    n = 8 if is_sps or t8 else 6
    for i in range(n):
        size = 16 if i < 6 else 64
        r = rs.rand()
        if r < 0.3:
            syntax.append(None)
        elif r < 0.45:
            syntax.append("default")
        else:
            base = rs.randint(6, 40)
            vals = np.clip(base + np.arange(size) * rs.randint(0, 3)
                           + rs.randint(-3, 4, size), 1, 255)
            syntax.append([int(v) for v in vals])
    scan4, scan8 = ZZ4, ZZ8
    for i in range(6):
        s = syntax[i]
        dflt = DEF4[0 if i < 3 else 1]
        if s is None:
            if i in (0, 3):
                if not is_sps and sps_lists is not None:
                    v = sps_lists["l4"][i]
                else:
                    v = dflt
            else:
                v = lists4[i - 1]
        elif s == "default":
            v = dflt
        else:
            v = np.zeros(16, np.int64)
            v[scan4] = s
        lists4.append(np.asarray(v, np.int64))
    if n == 8:
        for i in range(2):
            s = syntax[6 + i]
            dflt = DEF8[i]
            if s is None:
                if not is_sps and sps_lists is not None:
                    v = sps_lists["l8"][i]
                else:
                    v = dflt
            elif s == "default":
                v = dflt
            else:
                v = np.zeros(64, np.int64)
                v[scan8] = s
            lists8.append(np.asarray(v, np.int64))
    elif sps_lists is not None:
        lists8 = [sps_lists["l8"][0], sps_lists["l8"][1]]
    else:
        lists8 = [np.full(64, 16, np.int64)] * 2
    return {"syntax": syntax, "l4": lists4, "l8": lists8}


def _put_scaling(w, syntax):
    for s in syntax:
        w.bit(s is not None)
        if s is None:
            continue
        if s == "default":
            w.se(-8)  # nextScale 0 at j = 0
            continue
        last = 8
        for v in s:
            d = (v - last + 128) % 256 - 128
            w.se(d)
            last = v


class _Pps:
    def __init__(self, rs, spec: Spec, pps_id: int, sps: _Sps, cabac: bool):
        self.id, self.sps = pps_id, sps
        self.cabac = cabac
        self.forms = spec.forms
        self.num_ref_default = int(rs.randint(1, max(1, spec.refs) + 1))
        self.weighted = spec.weighted
        self.init_qp = int(rs.randint(20, 33))
        self.cqp = [int(rs.randint(-4, 5)), int(rs.randint(-4, 5))]
        if spec.profile < 100:
            self.cqp[1] = self.cqp[0]
        self.deblocking_control = spec.deblock != (0,)
        self.constrained = spec.constrained
        self.t8 = spec.t8 and spec.profile >= 100
        self.scaling = None
        if spec.scaling in ("pps", "both") and spec.profile >= 100:
            self.scaling = _scaling_lists(
                rs, False, sps.scaling if sps.scaling else None, self.t8)
        if self.scaling is not None:
            self.l4, self.l8 = self.scaling["l4"], self.scaling["l8"]
        elif sps.scaling is not None:
            self.l4, self.l8 = sps.scaling["l4"], sps.scaling["l8"]
        else:
            self.l4 = [np.full(16, 16, np.int64)] * 6
            self.l8 = [np.full(64, 16, np.int64)] * 2
        self.ls4_dc = [int(max(self.l4[i][0] * _norm4(m, 0) for m in range(6)))
                       for i in range(6)]
        self.scales = {}  # (size, list, qp) -> factors by scan position

    def rbsp(self) -> bytes:
        w = BitWriter()
        w.ue(self.id)
        w.ue(self.sps.id)
        w.bit(self.cabac)
        w.bit(0)
        fmo = "fmo" in self.forms
        w.ue(int(fmo))
        if fmo:
            w.ue(2)  # slice_group_map_type: foreground with left-over
            w.ue(0)
            w.ue(1)
        w.ue(self.num_ref_default - 1)
        w.ue(0)
        w.bit(self.weighted)
        w.u(2, 0)
        w.se(self.init_qp - 26)
        w.se(0)
        w.se(self.cqp[0])
        w.bit(self.deblocking_control)
        w.bit(self.constrained)
        w.bit("redundant" in self.forms)
        if self.sps.profile >= 100:
            w.bit(self.t8)
            w.bit(self.scaling is not None)
            if self.scaling is not None:
                _put_scaling(w, self.scaling["syntax"])
            w.se(self.cqp[1])
        w.trailing()
        return w.bytes()


class _Pic:
    """Syntax-level state of the picture being written."""

    def __init__(self, mb_w, mb_h):
        self.mb_w, self.mb_h = mb_w, mb_h
        n = mb_w * mb_h
        w4, h4 = mb_w * 4, mb_h * 4
        self.slice = [-1] * n
        self.type = [""] * n
        self.intra = [False] * n
        self.cbp = [0] * n
        self.t8 = [False] * n
        self.cdc = [0] * n
        self.cmode = [0] * n
        self.nz = np.zeros((h4, w4), np.int64)
        self.nzc = np.zeros((2, mb_h * 2, mb_w * 2), np.int64)
        self.ipm = np.full((h4, w4), -1, np.int64)
        self.ref = np.full((h4, w4), -1, np.int64)
        self.mvd = np.zeros((h4, w4, 2), np.int64)


# ------------------------------------------------------------- the writer

class Writer:
    def __init__(self, spec: Spec):
        self.spec = spec
        self.rs = np.random.RandomState(spec.seed)
        rs = self.rs
        self.spss = [_Sps(rs, spec, i, t)
                     for i, t in enumerate(spec.poc_types)]
        self.sps_idx = 0
        self.ppss: List[_Pps] = []
        self._make_ppss(first=True)
        self.frame_num = 0
        self.prev_ref_fn = 0
        self.poc_lsb = 0
        self.idr_id = 0
        self.dpb: List[int] = []   # frame_num of short-term references
        self.fn_offset = 0
        self.last_nonref = False
        self.picture_index = 0

    @property
    def sps(self) -> _Sps:
        return self.spss[self.sps_idx]

    def _make_ppss(self, first=False):
        spec, rs = self.spec, self.rs
        modes = {"cavlc": [False], "cabac": [True],
                 "mixed": [False, True]}[spec.entropy]
        n = 2 if spec.entropy != "mixed" else 3
        base = 0 if first else len(self.ppss)
        self.ppss = [_Pps(rs, spec, (base + i) % 256, self.sps,
                          modes[i % len(modes)]) for i in range(n)]

    def units(self) -> List[Tuple[List[bytes], bool]]:
        """Every access unit: (NAL units, IDR?)."""
        return [self.picture(i) for i in range(self.spec.frames)]

    def picture(self, i) -> Tuple[List[bytes], bool]:
        spec, rs = self.spec, self.rs
        idr = i == 0 or (spec.idr_every and i % spec.idr_every == 0)
        nals = []
        if spec.extra_nals:
            nals.append(nal_unit(0, 9, bytes([0xF0])))  # AUD, any type
        if idr:
            if i:
                self.sps_idx = (self.sps_idx + 1) % len(self.spss)
                self._make_ppss()
            nals.append(nal_unit(3, 7, self.sps.rbsp()))
            nals += [nal_unit(3, 8, p.rbsp()) for p in self.ppss]
            self.dpb = []
            self.frame_num = 0
            self.prev_ref_fn = 0
            self.fn_offset = 0
            self.last_nonref = False
        elif spec.change_pps and rs.rand() < 0.3:
            k = rs.randint(len(self.ppss))
            old = self.ppss[k]
            new = _Pps(rs, spec, old.id, self.sps, old.cabac)
            self.ppss[k] = new
            nals.append(nal_unit(3, 8, new.rbsp()))
        if spec.extra_nals:  # SEI user_data_unregistered, SVC prefix unit
            nals.append(nal_unit(0, 6, bytes([5, 17]) + bytes(range(16))
                                 + b"!\x80"))
            nals.append(nal_unit(3, 14, bytes([0x80, 0, 0, 0x80])))
        islice = idr or (spec.i_every and i % spec.i_every == 0)
        sps = self.sps
        ref_idc = 3
        if not idr and not islice and rs.rand() < spec.nonref and (
                sps.poc_type != 2 or not self.last_nonref):
            ref_idc = 0
        pps = self.ppss[rs.randint(len(self.ppss))]
        max_fn = 1 << sps.log2_max_fn
        fn = 0 if idr else (self.prev_ref_fn + 1) % max_fn
        # POC syntax: pictures 2 apart in POC
        if idr:
            self.poc_count = 0
        else:
            self.poc_count += 2
        if "poc_order" in spec.forms and i in (1, 2, 3):
            self.poc_count += {1: 2, 2: -4, 3: 2}[i]
        lsb = self.poc_count % (1 << sps.log2_max_lsb)
        if idr:
            self.idr_id = (self.idr_id + 1) % 4
        delta = (self._poc1_delta(sps, fn, ref_idc, idr)
                 if sps.poc_type == 1 else 0)
        pic = _Pic(sps.mb_w, sps.mb_h)
        n_mbs = sps.mb_w * sps.mb_h
        k = rs.randint(1, spec.slices + 1) if spec.slices > 1 else 1
        starts = sorted(set([0] + rs.randint(1, n_mbs, k - 1).tolist()))
        starts.append(n_mbs)
        fixed = rs.rand() < 0.5  # slice_type 5-9: every slice of one type
        for s in range(len(starts) - 1):
            st = 2 if islice or (not fixed and rs.rand() < 0.1) else 0
            if i == 1 and spec.forms:
                for form, t in (("b_slice", 1), ("sp_slice", 3),
                                ("si_slice", 4)):
                    if form in spec.forms:
                        st = t
            self.picture_index = i
            nals.append(self.slice(pic, s, starts[s], starts[s + 1], st, idr,
                                   ref_idc, pps, fn, lsb, delta, fixed))
            if i == 1 and "partitions" in spec.forms:
                nals.append(nal_unit(ref_idc, 2, b"\x80"))
            if spec.extra_nals and s == 0:
                nals.append(nal_unit(0, 12, b"\xff" * 3 + b"\x80"))  # filler
                # an MVC/SVC slice extension (type 20), which AVC skips
                nals.append(nal_unit(ref_idc, 20, bytes([0x80, 0x11, 0x80])))
        if ref_idc:
            self.prev_ref_fn = fn
            if not idr and len(self.dpb) >= max(1, sps.max_refs):
                wraps = [f - max_fn if f > fn else f for f in self.dpb]
                del self.dpb[int(np.argmin(wraps))]
            self.dpb.append(fn)
        self.frame_num = fn
        self.last_nonref = ref_idc == 0
        return nals, bool(idr)

    # ----------------------------------------------------------- slices

    def slice(self, pic, sidx, first, end, stype, idr, ref_idc, pps, fn,
              lsb, delta, fixed) -> bytes:
        spec, rs, sps = self.spec, self.rs, pps.sps
        w = BitWriter()
        w.ue(first)
        w.ue(stype + (5 if fixed else 0))
        w.ue(pps.id)
        w.u(sps.log2_max_fn, fn)
        if idr:
            w.ue(self.idr_id)
        if sps.poc_type == 0:
            w.u(sps.log2_max_lsb, lsb)
        elif sps.poc_type == 1 and not sps.always_zero:
            w.se(delta)
        num_ref = 1
        refs_avail = len(self.dpb)
        if stype == 1:  # a refused B slice: the header's start suffices
            w.trailing()
            return nal_unit(ref_idc, 1, w.bytes())
        if stype in (3, 4):
            stype = 0 if stype == 3 else 2
        if stype == 0:
            num_ref = pps.num_ref_default
            override = num_ref > refs_avail or rs.rand() < 0.3
            if override:
                num_ref = int(rs.randint(1, refs_avail + 1))
            w.bit(override)
            if override:
                w.ue(num_ref - 1)
            mods = spec.listmod and refs_avail > 1 and rs.rand() < 0.6
            long_term = ("long_term_list" in spec.forms
                         and self.picture_index == 1)
            w.bit(mods or long_term)
            if long_term:
                w.ue(2)
                w.ue(0)
                w.ue(3)
            elif mods:
                self._list_mods(w, sps, fn, num_ref)
            if pps.weighted:
                self._weights(w, num_ref)
        if ref_idc:
            if idr:
                w.bit(0)
                w.bit("long_term" in spec.forms)
            elif "mmco" in spec.forms and self.picture_index == 2:
                w.bit(1)
                w.ue(1)  # mark a short-term picture unused
                w.ue(0)
                w.ue(0)
            else:
                w.bit(0)
        init_idc = 0
        if pps.cabac and stype != 2:
            init_idc = int(rs.randint(3))
            w.ue(init_idc)
        qp = int(rs.randint(spec.qp[0], spec.qp[1] + 1))
        if spec.escapes and rs.rand() < 0.3:
            qp = int(rs.randint(0, 6))
        w.se(qp - pps.init_qp)
        if pps.deblocking_control:
            idc = int(rs.choice(spec.deblock))
            w.ue(idc)
            if idc != 1:
                w.se(int(rs.randint(-6, 7)))
                w.se(int(rs.randint(-6, 7)))
        # slice data
        ctx = _SliceCtx(self, pic, sidx, pps, stype, qp, num_ref, w)
        if pps.cabac:
            w.align(1)
            ctx.enc = CabacEncoder(w)
            ctx.enc.init_contexts(0 if stype == 2 else 1 + init_idc, qp)
        ctx.run(first, end)
        return nal_unit(ref_idc, 5 if idr else 1, w.bytes())

    def _poc1_delta(self, sps, fn, ref_idc, idr):
        """delta_pic_order_cnt[0] that keeps the POC at self.poc_count."""
        max_fn = 1 << sps.log2_max_fn
        if idr:
            self.fn_offset = 0
        elif self.frame_num > fn:
            self.fn_offset += max_fn
        n = len(sps.cycle)
        absfn = self.fn_offset + fn
        if not ref_idc and absfn > 0:
            absfn -= 1
        exp = 0
        if absfn > 0:
            cyc, inc = divmod(absfn - 1, n)
            exp = cyc * sum(sps.cycle) + sum(sps.cycle[:inc + 1])
        if not ref_idc:
            exp += sps.offset_nonref
        return self.poc_count - exp

    def _list_mods(self, w, sps, fn, num_ref):
        rs = self.rs
        max_fn = 1 << sps.log2_max_fn
        nums = [f - max_fn if f > fn else f for f in self.dpb]
        pred = fn
        for _ in range(rs.randint(1, num_ref + 1)):
            target = int(rs.choice(nums))
            no_wrap = target % max_fn
            d = no_wrap - pred
            # idc 0 subtracts, 1 adds (modulo max_fn)
            if d < 0 or (d == 0 and rs.rand() < 0.5):
                diff = (pred - no_wrap) % max_fn
                if diff == 0:
                    diff = max_fn
                w.ue(0)
                w.ue(diff - 1)
            else:
                diff = (no_wrap - pred) % max_fn
                if diff == 0:
                    diff = max_fn
                w.ue(1)
                w.ue(diff - 1)
            pred = no_wrap
        w.ue(3)

    def _weights(self, w, num_ref):
        rs = self.rs
        l2, c2 = int(rs.randint(0, 8)), int(rs.randint(0, 8))
        w.ue(l2)
        w.ue(c2)
        def weight(log2):  # around 2^log2, as a fade would give
            one = 1 << log2
            return int(np.clip(one + rs.randint(-one // 2 - 2, one // 2 + 3),
                               -128, 127))

        for _ in range(num_ref):
            f = rs.rand() < 0.7
            w.bit(f)
            if f:
                w.se(weight(l2))
                w.se(int(rs.randint(-20, 21)))
            f = rs.rand() < 0.6
            w.bit(f)
            if f:
                for _ in range(2):
                    w.se(weight(c2))
                    w.se(int(rs.randint(-20, 21)))


_COUNTS = (1, 1, 2, 2, 3, 4, 6, 9, 16)  # non-zero levels a coded block
# sums of |level| x dequantisation factor: drawn within SOFT (natural
# residuals), never past HARD (16-bit transform lanes: a 4x4 output is
# within the sum, an 8x8 one within 2.25 x the sum); DC terms within
# DC_BUDGET, which their 4x4 blocks' AC budget leaves room for
SOFT4, HARD4, SOFT8, HARD8, DC_BUDGET = 3000, 28000, 2000, 14000, 750
INTRA_IN_P = 0.1  # share of intra macroblocks in P slices


def _pick(rs, options):
    return options[rs.randint(len(options))]


class _SliceCtx:
    """Writes one slice's macroblocks."""

    def __init__(self, wr: Writer, pic: _Pic, sidx, pps: _Pps, stype, qp,
                 num_ref, w: BitWriter):
        self.wr, self.pic, self.sidx, self.pps = wr, pic, sidx, pps
        self.rs, self.spec = wr.rs, wr.spec
        self.stype, self.qp, self.num_ref, self.w = stype, qp, num_ref, w
        self.enc: Optional[CabacEncoder] = None
        self.last_dqp = 0
        self.mb_w = pic.mb_w

    # ------------------------------------------------------ neighbours

    def avail(self, addr):
        return addr >= 0 and self.pic.slice[addr] == self.sidx

    def nb_mb(self, mbaddr, dx, dy):
        mx, my = mbaddr % self.mb_w, mbaddr // self.mb_w
        x, y = mx + dx, my + dy
        if x < 0 or y < 0 or x >= self.mb_w:
            return -1
        a = y * self.mb_w + x
        return a if self.avail(a) else -1

    def run(self, first, end):
        enc, pic = self.enc, self.pic
        skip_run = 0
        for a in range(first, end):
            pic.slice[a] = self.sidx
            skip = self.stype == 0 and self.rs.rand() < self.spec.skip
            if enc is not None:
                if self.stype == 0:
                    mx = a % self.mb_w
                    inc = int(mx > 0 and self.avail(a - 1)
                              and pic.type[a - 1] != "skip")
                    inc += int(a >= self.mb_w and self.avail(a - self.mb_w)
                               and pic.type[a - self.mb_w] != "skip")
                    enc.decision(11 + inc, int(skip))
                if skip:
                    self.skip_mb(a)
                else:
                    self.mb(a)
                enc.terminate(int(a == end - 1))
            else:
                if skip:
                    skip_run += 1
                    self.skip_mb(a)
                    continue
                if self.stype == 0:
                    self.w.ue(skip_run)
                    skip_run = 0
                self.mb(a)
        if enc is None:
            if skip_run:
                self.w.ue(skip_run)
            self.w.trailing()
        else:
            self.w.align(0)

    def clear(self, a):
        pic = self.pic
        mx, my = a % self.mb_w, a // self.mb_w
        sl = (slice(my * 4, my * 4 + 4), slice(mx * 4, mx * 4 + 4))
        pic.nz[sl] = 0
        pic.ipm[sl] = -1
        pic.mvd[sl] = 0
        pic.nzc[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
        pic.ref[sl] = -1
        return mx, my

    def skip_mb(self, a):
        pic = self.pic
        mx, my = self.clear(a)
        pic.type[a], pic.intra[a], pic.cbp[a] = "skip", False, 0
        pic.t8[a] = False
        pic.cdc[a], pic.cmode[a] = 0, 0
        pic.ref[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        self.last_dqp = 0

    # ------------------------------------------------------ macroblock

    def mb(self, a):
        rs, pic, pps, spec = self.rs, self.pic, self.pps, self.spec
        mx, my = self.clear(a)
        enc, w = self.enc, self.w
        intra = self.stype == 2 or rs.rand() < INTRA_IN_P
        pic.intra[a] = intra
        pic.cdc[a], pic.cmode[a], pic.t8[a] = 0, 0, False
        if intra:
            r = rs.rand()
            if r < spec.pcm:
                kind = "pcm"
            elif r < 0.45:
                kind = "i16"
            elif pps.t8 and r < 0.7:
                kind = "i8"
            else:
                kind = "i4"
        else:
            opts = ["16x16", "16x8", "8x16", "8x8"]
            if enc is None and self.num_ref > 1:
                opts.append("8x8ref0")
            kind = opts[rs.randint(len(opts))]
        pic.type[a] = kind
        if kind == "pcm":
            self.put_mb_type(a, 25, intra=True)
            w.align(0)
            for v in self.pcm_samples():
                w.u(8, int(v))
            if enc is not None:
                enc.reset()
                # the decoder re-reads 9 bits: the encoder starts afresh
            pic.nz[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 16
            pic.nzc[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 16
            pic.cbp[a], pic.cdc[a] = 0x2F, 7
            self.last_dqp = 0
            return
        cbp = int(rs.randint(0, 16)) | (int(rs.randint(0, 3)) << 4)
        if rs.rand() > 0.85 * spec.coded:
            cbp = 0
        if kind == "i16":
            mode = self.i16_mode(a)
            cbp = (15 if rs.rand() < 0.5 else 0) | (int(rs.randint(0, 3)) << 4)
            t = 1 + mode + 4 * (cbp >> 4) + (12 if cbp & 15 else 0)
            self.put_mb_type(a, t, intra=True)
            self.put_chroma_mode(a)
        elif kind in ("i4", "i8"):
            self.put_mb_type(a, 0, intra=True)
            if pps.t8:
                self.put_t8(a, kind == "i8")
            pic.t8[a] = kind == "i8"
            self.put_intra_modes(a, kind == "i8")
            self.put_chroma_mode(a)
        else:
            self.inter_pred(a, kind)
        if kind != "i16":
            self.put_cbp(a, cbp, intra)
            if (cbp & 15 and pps.t8 and not intra and
                    (kind not in ("8x8", "8x8ref0") or self.all_sub8x8)):
                t8 = bool(rs.rand() < 0.5)
                self.put_t8(a, t8)
                pic.t8[a] = t8
        pic.cbp[a] = cbp
        if cbp & 63 or kind == "i16":
            self.put_dqp()
        else:
            self.last_dqp = 0
        self.put_residual(a, kind, cbp, intra)

    def pcm_samples(self):
        rs = self.rs
        base = rs.randint(40, 216, 3)
        y = np.clip(base[0] + rs.randint(-20, 21, 256), 0, 255)
        u = np.clip(base[1] + rs.randint(-10, 11, 64), 1, 255)
        v = np.clip(base[2] + rs.randint(-10, 11, 64), 1, 255)
        return np.concatenate([y, u, v])

    def put_mb_type(self, a, t, intra):
        """t: the I mb_type (0 I_NxN, 1-24 I_16x16, 25 I_PCM) when intra,
        else the P mb_type 0-4."""
        enc, w, pic = self.enc, self.w, self.pic
        islice = self.stype == 2
        if enc is None:
            w.ue(t if islice else (t + 5 if intra else t))
            return
        if not intra:
            enc.decision(14, 0)
            if t == 0:
                enc.decision(15, 0)
                enc.decision(16, 0)
            elif t == 3:
                enc.decision(15, 0)
                enc.decision(16, 1)
            else:
                enc.decision(15, 1)
                enc.decision(17, 1 if t == 1 else 0)
            return
        if islice:
            base = 3
            inc = 0
            for n in (self.nb_mb(a, -1, 0), self.nb_mb(a, 0, -1)):
                if n >= 0 and pic.type[n] not in ("i4", "i8"):
                    inc += 1
            enc.decision(base + inc, int(t != 0))
            if t == 0:
                return
            base += 2
        else:
            enc.decision(14, 1)
            base = 17
            enc.decision(base, int(t != 0))
            if t == 0:
                return
        i = int(islice)
        enc.terminate(int(t == 25))
        if t == 25:
            return
        v = t - 1
        luma, chroma, mode = v >= 12, (v // 4) % 3, v % 4
        enc.decision(base + 1, int(luma))
        enc.decision(base + 2, int(chroma != 0))
        if chroma:
            enc.decision(base + 2 + i, int(chroma == 2))
        enc.decision(base + 3 + i, mode >> 1)
        enc.decision(base + 3 + 2 * i, mode & 1)

    def put_t8(self, a, v):
        if self.enc is None:
            self.w.bit(v)
            return
        inc = sum(int(n >= 0 and self.pic.t8[n])
                  for n in (self.nb_mb(a, -1, 0), self.nb_mb(a, 0, -1)))
        self.enc.decision(399 + inc, int(v))

    # ---------------------------------------------------- intra modes

    def intra_ok(self, n):
        return n >= 0 and (not self.pps.constrained or self.pic.intra[n])

    def i16_mode(self, a):
        A, B, D = (self.intra_ok(self.nb_mb(a, -1, 0)),
                   self.intra_ok(self.nb_mb(a, 0, -1)),
                   self.intra_ok(self.nb_mb(a, -1, -1)))
        ok = [2] + ([0] if B else []) + ([1] if A else []) + (
            [3] if A and B and D else [])
        return _pick(self.rs, ok)

    def put_chroma_mode(self, a):
        A, B, D = (self.intra_ok(self.nb_mb(a, -1, 0)),
                   self.intra_ok(self.nb_mb(a, 0, -1)),
                   self.intra_ok(self.nb_mb(a, -1, -1)))
        ok = [0] + ([1] if A else []) + ([2] if B else []) + (
            [3] if A and B and D else [])
        m = _pick(self.rs, ok)
        self.pic.cmode[a] = m
        if self.enc is None:
            self.w.ue(m)
            return
        inc = sum(int(n >= 0 and self.pic.cmode[n] != 0)
                  for n in (self.nb_mb(a, -1, 0), self.nb_mb(a, 0, -1)))
        self.enc.decision(64 + inc, int(m > 0))
        if m > 0:
            self.enc.decision(67, int(m > 1))
            if m > 1:
                self.enc.decision(67, int(m > 2))

    def put_intra_modes(self, a, t8):
        pic, rs, enc, w = self.pic, self.rs, self.enc, self.w
        mx, my = a % self.mb_w, a // self.mb_w
        A = self.intra_ok(self.nb_mb(a, -1, 0))
        B = self.intra_ok(self.nb_mb(a, 0, -1))
        C = self.intra_ok(self.nb_mb(a, 1, -1))
        D = self.intra_ok(self.nb_mb(a, -1, -1))
        nblk = 4 if t8 else 16
        for k in range(nblk):
            bx = (k & 1) * 2 if t8 else BLK_X[k]
            by = (k >> 1) * 2 if t8 else BLK_Y[k]
            ht = by > 0 or B
            hl = bx > 0 or A
            htl = ((bx > 0 and by > 0) or (bx == 0 and by > 0 and A)
                   or (bx > 0 and by == 0 and B)
                   or (bx == 0 and by == 0 and D))
            ok = [2] + ([0, 3, 7] if ht else []) + ([1, 8] if hl else []) + (
                [4, 5, 6] if ht and hl and htl else [])
            mode = _pick(rs, ok)
            # predicted mode
            def nbmode(nx, ny):
                if nx >= 0 and ny >= 0:
                    return int(pic.ipm[my * 4 + ny, mx * 4 + nx])
                n = self.nb_mb(a, -1 if nx < 0 else 0, -1 if ny < 0 else 0)
                if n < 0:
                    return -1
                if not pic.intra[n] and self.pps.constrained:
                    return -1
                if pic.type[n] not in ("i4", "i8"):
                    return 2
                return int(pic.ipm[my * 4 + ny, mx * 4 + nx])
            ma, mb_ = nbmode(bx - 1, by), nbmode(bx, by - 1)
            pred = 2 if ma < 0 or mb_ < 0 else min(ma, mb_)
            if mode == pred:
                self._put_mode_bits(True, 0)
            else:
                self._put_mode_bits(False, mode if mode < pred else mode - 1)
            span = 2 if t8 else 1
            pic.ipm[my * 4 + by:my * 4 + by + span,
                    mx * 4 + bx:mx * 4 + bx + span] = mode

    def _put_mode_bits(self, prev, rem):
        if self.enc is None:
            self.w.bit(prev)
            if not prev:
                self.w.u(3, rem)
            return
        self.enc.decision(68, int(prev))
        if not prev:
            for i in range(3):
                self.enc.decision(69, (rem >> i) & 1)

    # --------------------------------------------------------- inter

    def inter_pred(self, a, kind):
        rs, pic, enc, w = self.rs, self.pic, self.enc, self.w
        mx, my = a % self.mb_w, a // self.mb_w
        t = {"16x16": 0, "16x8": 1, "8x16": 2, "8x8": 3, "8x8ref0": 4}[kind]
        self.put_mb_type(a, t, intra=False)
        subs = [0, 0, 0, 0]
        if t >= 3:
            subs = [int(v) for v in rs.randint(0, 4, 4)]
            for s in subs:
                if enc is None:
                    w.ue(s)
                elif s == 0:
                    enc.decision(21, 1)
                else:
                    enc.decision(21, 0)
                    enc.decision(22, int(s != 1))
                    if s != 1:
                        enc.decision(23, int(s == 2))
        self.all_sub8x8 = not any(subs)
        if t == 0:
            parts = [(0, 0, 4, 4)]
        elif t == 1:
            parts = [(0, 0, 4, 2), (0, 2, 4, 2)]
        elif t == 2:
            parts = [(0, 0, 2, 4), (2, 0, 2, 4)]
        else:
            parts = [(0, 0, 2, 2), (2, 0, 2, 2), (0, 2, 2, 2), (2, 2, 2, 2)]
        for (x, y, pw, ph) in parts:
            r = 0
            if self.num_ref > 1 and t != 4:
                r = int(rs.randint(self.num_ref))
                if enc is None:
                    w.te(self.num_ref - 1, r)
                else:
                    def gt0(nx, ny):
                        gx, gy = mx * 4 + nx, my * 4 + ny
                        if gx < 0 or gy < 0:
                            return 0
                        n = (gy // 4) * self.mb_w + gx // 4
                        if n != a and not self.avail(n):
                            return 0
                        if n != a and (pic.type[n] == "skip" or pic.intra[n]):
                            return 0
                        return int(pic.ref[gy, gx] > 0)
                    ctx = gt0(x - 1, y) + 2 * gt0(x, y - 1)
                    for i in range(r):
                        enc.decision(54 + ctx, 1)
                        ctx = 4 if ctx < 4 else 5
                    enc.decision(54 + ctx, 0)
            pic.ref[my * 4 + y:my * 4 + y + ph, mx * 4 + x:mx * 4 + x + pw] = r
        for i, (x, y, pw, ph) in enumerate(parts):
            if t >= 3:
                s = subs[i]
                sw, sh = (2, 2) if s == 0 else (2, 1) if s == 1 else (
                    1, 2) if s == 2 else (1, 1)
                subparts = [(x + dx, y + dy) for dy in range(0, 2, sh)
                            for dx in range(0, 2, sw)]
            else:
                sw, sh = pw, ph
                subparts = [(x, y)]
            for (sx, sy) in subparts:
                d = [self.mvd_value(), self.mvd_value()]
                for comp in range(2):
                    self.put_mvd(a, sx, sy, comp, d[comp])
                pic.mvd[my * 4 + sy:my * 4 + sy + sh,
                        mx * 4 + sx:mx * 4 + sx + sw] = np.abs(d)

    def mvd_value(self):
        rs = self.rs
        r = rs.rand()
        if r < 0.4:
            return 0
        if r < 0.85:
            return int(rs.randint(-8, 9))
        if r < 0.97:
            return int(rs.randint(-40, 41))
        return int(rs.randint(-200, 201))

    def put_mvd(self, a, sx, sy, comp, v):
        if self.enc is None:
            self.w.se(v)
            return
        pic, enc = self.pic, self.enc
        mx, my = a % self.mb_w, a // self.mb_w
        s = 0
        for (nx, ny) in ((sx - 1, sy), (sx, sy - 1)):
            gx, gy = mx * 4 + nx, my * 4 + ny
            if gx < 0 or gy < 0:
                continue
            n = (gy // 4) * self.mb_w + gx // 4
            if n != a and not self.avail(n):
                continue
            s += int(min(pic.mvd[gy, gx, comp], 255))
        base = 47 if comp else 40
        inc = 0 if s < 3 else 1 if s <= 32 else 2
        av = abs(v)
        enc.decision(base + inc, int(av > 0))
        if not av:
            return
        ctx = base + 3
        k = 1
        while k < 9:
            enc.decision(ctx, int(av > k))
            if av <= k:
                break
            if k < 4:
                ctx += 1
            k += 1
        if av >= 9:
            self._ueg(av - 9, 3)
        enc.bypass(int(v < 0))

    def _ueg(self, v, k):
        enc = self.enc
        while v >= (1 << k):
            enc.bypass(1)
            v -= 1 << k
            k += 1
        enc.bypass(0)
        while k:
            k -= 1
            enc.bypass((v >> k) & 1)

    # ------------------------------------------------------- cbp / qp

    def put_cbp(self, a, cbp, intra):
        if self.enc is None:
            self.w.ue((INTRA_CBP if intra else INTER_CBP)[cbp])
            return
        pic, enc = self.pic, self.enc
        for b8 in range(4):
            bx, by = (b8 & 1) * 2, (b8 >> 1) * 2
            def cond(nx, ny):
                if nx >= 0 and ny >= 0:
                    return int(not (cbp >> ((ny >> 1) * 2 + (nx >> 1))) & 1)
                n = self.nb_mb(a, -1 if nx < 0 else 0, -1 if ny < 0 else 0)
                if n < 0 or pic.type[n] == "pcm":
                    return 0
                ax, ay = (3 if nx < 0 else nx), (3 if ny < 0 else ny)
                return int(not (pic.cbp[n] >> ((ay >> 1) * 2 + (ax >> 1))) & 1)
            enc.decision(73 + cond(bx - 1, by) + 2 * cond(bx, by - 1),
                         (cbp >> b8) & 1)
        def cc(n, b):
            if n < 0:
                return 0
            c = pic.cbp[n] >> 4
            return int(c == 2) if b else int(c != 0)
        na, nb = self.nb_mb(a, -1, 0), self.nb_mb(a, 0, -1)
        c = cbp >> 4
        enc.decision(77 + cc(na, 0) + 2 * cc(nb, 0), int(c != 0))
        if c:
            enc.decision(81 + cc(na, 1) + 2 * cc(nb, 1), int(c == 2))

    def put_dqp(self):
        rs = self.rs
        r = rs.rand()
        lo, hi = self.spec.qp
        if r < 0.5:
            dq = 0
        elif r < 0.95:
            dq = int(np.clip(rs.randint(lo, hi + 1) - self.qp, -26, 25))
        elif self.qp > 26:  # across the 0-51 wrap
            dq = int(rs.randint(52 - self.qp, 26))
        elif self.qp < 26:
            dq = -int(rs.randint(self.qp + 1, 27))
        else:
            dq = 0
        self.qp = (self.qp + dq + 52) % 52
        if self.enc is None:
            self.w.se(dq)
        else:
            enc = self.enc
            enc.decision(60 + int(self.last_dqp != 0), int(dq != 0))
            if dq:
                k = 2 * dq - 1 if dq > 0 else -2 * dq
                ctx = 62
                for _ in range(k - 1):
                    enc.decision(ctx, 1)
                    ctx = 63
                enc.decision(ctx, 0)
        self.last_dqp = dq

    # ------------------------------------------------------- residual

    def levels(self, scales, soft, hard):
        """Sparse levels (scan order) at positions whose dequantisation
        factors are ``scales``: |level| x factor sums to at most ``soft``
        for the magnitudes drawn and never past ``hard`` (FFmpeg's x86
        transforms work in 16-bit lanes); a position whose factor alone
        passes ``hard`` stays 0."""
        rs = self.rs
        out = [0] * len(scales)
        feas = [i for i, f in enumerate(scales) if f <= hard]
        if not feas:
            return out
        k = min(len(feas), _COUNTS[rs.randint(len(_COUNTS))])
        if rs.rand() < 0.25:
            k = int(rs.randint(1, len(feas) + 1))
        pos = sorted(feas[j] for j in rs.permutation(len(feas))[:k])
        total = 0.0
        for p in pos:
            r = rs.rand()
            mag = 1 if r < 0.6 else 2 if r < 0.8 else int(rs.randint(3, 12))
            if self.spec.escapes and r > 0.93:
                mag = int(rs.randint(12, 400))
            mag = max(1, min(mag, int(soft / (k * scales[p]))))
            if total + mag * scales[p] > hard:
                continue
            total += mag * scales[p]
            out[p] = mag if rs.rand() < 0.5 else -mag
        if not any(out):
            out[pos[0]] = 1
        return out

    def scales4(self, lst, qp, ac=False):
        """Dequantisation factor of each scan position of a 4x4 block."""
        key = (4, lst, qp)
        if key not in self.pps.scales:
            self.pps.scales[key] = [
                float(self.pps.l4[lst][i] * _norm4(qp % 6, i)
                      * (1 << (qp // 6)) / 16.0) for i in ZZ4]
        return self.pps.scales[key][1:] if ac else self.pps.scales[key]

    def scales8(self, lst, qp):
        key = (8, lst, qp)
        if key not in self.pps.scales:
            self.pps.scales[key] = [
                float(self.pps.l8[lst][i] * _norm8(qp % 6, i)
                      * (1 << (qp // 6)) / 64.0) for i in ZZ8]
        return self.pps.scales[key]

    def put_residual(self, a, kind, cbp, intra):
        pic, rs = self.pic, self.rs
        mx, my = a % self.mb_w, a // self.mb_w
        qp = self.qp
        lst = 0 if intra else 3
        t8 = pic.t8[a]
        cab = self.enc is not None
        if kind == "i16":
            f = self.pps.ls4_dc[0] * (1 << (qp // 6)) / 64.0
            dc = (self.levels([f] * 16, DC_BUDGET, DC_BUDGET)
                  if rs.rand() < 0.7 else [0] * 16)
            n = self.block(dc, 0, 16, self.cbf_dc(a, 0) if cab else None,
                           0, self.nc_luma(a, 0, 0))
            if n:
                pic.cdc[a] |= 1
            for k in range(16):
                bx, by = BLK_X[k], BLK_Y[k]
                cnt = 0
                if cbp & 15:
                    lv = (self.levels(self.scales4(0, qp, True), SOFT4, HARD4)
                          if rs.rand() < 0.5 else [0] * 15)
                    cnt = self.block(lv, 1, 15,
                                     self.cbf_luma(a, bx, by) if cab else None,
                                     1, self.nc_luma(a, bx, by))
                pic.nz[my * 4 + by, mx * 4 + bx] = cnt
        else:
            for b8 in range(4):
                if not (cbp >> b8) & 1:
                    continue
                bx0, by0 = (b8 & 1) * 2, (b8 >> 1) * 2
                if t8:
                    lst8 = 0 if intra else 1
                    lv = self.levels(self.scales8(lst8, qp), SOFT8, HARD8)
                    if cab:
                        n = self.block(lv, 0, 64, None, 5, 0)
                        pic.nz[my * 4 + by0:my * 4 + by0 + 2,
                               mx * 4 + bx0:mx * 4 + bx0 + 2] = n
                    else:
                        for k in range(4):
                            bx, by = bx0 + (k & 1), by0 + (k >> 1)
                            sub = lv[k::4]
                            cnt = self.block(sub, 0, 16, None, 2,
                                             self.nc_luma(a, bx, by))
                            pic.nz[my * 4 + by, mx * 4 + bx] = cnt
                else:
                    for k in range(4):
                        bi = b8 * 4 + k
                        bx, by = BLK_X[bi], BLK_Y[bi]
                        lv = (self.levels(self.scales4(lst, qp), SOFT4, HARD4)
                              if rs.rand() < 0.75 else [0] * 16)
                        if (self.spec.escapes and self.spec.profile >= 100
                                and self.scales4(lst, qp)[0] * 3000 <= 30000
                                and rs.rand() < 0.2):
                            # a lone DC past level_prefix 15
                            lv = [int(rs.choice([-1, 1])) * 3000] + [0] * 15
                        inc = self.cbf_luma(a, bx, by) if cab else None
                        cnt = self.block(lv, 0, 16, inc, 2,
                                         self.nc_luma(a, bx, by))
                        pic.nz[my * 4 + by, mx * 4 + bx] = cnt
        cbpc = cbp >> 4
        if cbpc:
            for c in range(2):
                qpc = CHROMA_QP[min(max(qp + self.pps.cqp[c], 0), 51)]
                l = (1 if intra else 4) + c
                f = self.pps.ls4_dc[l] * (1 << (qpc // 6)) / 32.0
                lv = (self.levels([f] * 4, DC_BUDGET, DC_BUDGET)
                      if rs.rand() < 0.8 else [0] * 4)
                inc = self.cbf_dc(a, 1 + c) if cab else None
                n = self.block(lv, 0, 4, inc, 3, -1)
                if n:
                    pic.cdc[a] |= 2 << c
        if cbpc == 2:
            for c in range(2):
                qpc = CHROMA_QP[min(max(qp + self.pps.cqp[c], 0), 51)]
                l = (1 if intra else 4) + c
                for k in range(4):
                    bx, by = k & 1, k >> 1
                    lv = (self.levels(self.scales4(l, qpc, True), SOFT4, HARD4)
                          if rs.rand() < 0.6 else [0] * 15)
                    inc = self.cbf_chroma(a, c, bx, by) if cab else None
                    cnt = self.block(lv, 1, 15, inc, 4,
                                     self.nc_chroma(a, c, bx, by))
                    pic.nzc[c, my * 2 + by, mx * 2 + bx] = cnt

    def nc_luma(self, a, bx, by):
        pic = self.pic
        mx, my = a % self.mb_w, a // self.mb_w
        aa = bx > 0 or self.nb_mb(a, -1, 0) >= 0
        ab = by > 0 or self.nb_mb(a, 0, -1) >= 0
        x, y = mx * 4 + bx, my * 4 + by
        na = int(pic.nz[y, x - 1]) if aa else 0
        nb = int(pic.nz[y - 1, x]) if ab else 0
        if aa and ab:
            return (na + nb + 1) >> 1
        return na if aa else nb if ab else 0

    def nc_chroma(self, a, c, bx, by):
        pic = self.pic
        mx, my = a % self.mb_w, a // self.mb_w
        aa = bx > 0 or self.nb_mb(a, -1, 0) >= 0
        ab = by > 0 or self.nb_mb(a, 0, -1) >= 0
        x, y = mx * 2 + bx, my * 2 + by
        na = int(pic.nzc[c, y, x - 1]) if aa else 0
        nb = int(pic.nzc[c, y - 1, x]) if ab else 0
        if aa and ab:
            return (na + nb + 1) >> 1
        return na if aa else nb if ab else 0

    def cbf_luma(self, a, bx, by):
        pic = self.pic
        intra = pic.intra[a]
        mx, my = a % self.mb_w, a // self.mb_w
        def cond(nx, ny):
            if nx < 0 or ny < 0:
                n = self.nb_mb(a, -1 if nx < 0 else 0, -1 if ny < 0 else 0)
                if n < 0:
                    return int(intra)
            return int(pic.nz[my * 4 + ny, mx * 4 + nx] != 0)
        return cond(bx - 1, by) + 2 * cond(bx, by - 1)

    def cbf_chroma(self, a, c, bx, by):
        pic = self.pic
        intra = pic.intra[a]
        mx, my = a % self.mb_w, a // self.mb_w
        def cond(nx, ny):
            if nx < 0 or ny < 0:
                n = self.nb_mb(a, -1 if nx < 0 else 0, -1 if ny < 0 else 0)
                if n < 0:
                    return int(intra)
            return int(pic.nzc[c, my * 2 + ny, mx * 2 + nx] != 0)
        return cond(bx - 1, by) + 2 * cond(bx, by - 1)

    def cbf_dc(self, a, bit):
        pic = self.pic
        r = 0
        for k, n in enumerate((self.nb_mb(a, -1, 0), self.nb_mb(a, 0, -1))):
            v = int(pic.intra[a]) if n < 0 else (pic.cdc[n] >> bit) & 1
            r += v << k
        return r

    def block(self, levels, start, maxc, cbf_inc, cat, nc) -> int:
        """Writes a residual block (levels in scan order from ``start``);
        returns the count of non-zero levels."""
        if self.enc is not None:
            return self._block_cabac(levels, maxc, cbf_inc, cat)
        return self._block_cavlc(levels, maxc, nc)

    def _block_cavlc(self, levels, maxc, nc):
        w = self.w
        nzpos = [i for i, v in enumerate(levels) if v]
        total = len(nzpos)
        coeffs = [levels[i] for i in nzpos][::-1]  # highest frequency first
        t1 = 0
        for v in coeffs:
            if abs(v) == 1 and t1 < 3:
                t1 += 1
            else:
                break
        if nc == -1:
            w.u(CDC_LEN[total * 4 + t1], CDC_BITS[total * 4 + t1])
        elif nc >= 8:
            w.u(6, 3 if total == 0 else ((total - 1) << 2) | t1)
        else:
            t = 0 if nc < 2 else 1 if nc < 4 else 2
            w.u(CT_LEN[t][total * 4 + t1], CT_BITS[t][total * 4 + t1])
        if not total:
            return 0
        sl = 1 if total > 10 and t1 < 3 else 0
        for i, v in enumerate(coeffs):
            if i < t1:
                w.bit(v < 0)
                continue
            code = 2 * v - 2 if v > 0 else -2 * v - 1
            if i == t1 and t1 < 3:
                code -= 2
            self._level(code, sl)
            if sl == 0:
                sl = 1
            if abs(v) > (3 << (sl - 1)) and sl < 6:
                sl += 1
        if total < maxc:
            tz = nzpos[-1] + 1 - total
            if maxc == 4:
                w.u(CTZ_LEN[total - 1][tz], CTZ_BITS[total - 1][tz])
            else:
                w.u(TZ_LEN[total - 1][tz], TZ_BITS[total - 1][tz])
            zeros = tz
        else:
            zeros = 0
        desc = nzpos[::-1]
        for i in range(total - 1):
            if zeros <= 0:
                break
            run = desc[i] - desc[i + 1] - 1
            t = min(zeros, 7) - 1
            w.u(RUN_LEN[t][run], RUN_BITS[t][run])
            zeros -= run
        return total

    def _level(self, code, sl):
        w = self.w
        if sl == 0:
            if code < 14:
                w.u(code + 1, 1)
                return
            if code < 30:
                w.u(15, 1)
                w.u(4, code - 14)
                return
            code -= 30
            p = 15
        else:
            if (code >> sl) < 15:
                w.u((code >> sl) + 1, 1)
                w.u(sl, code & ((1 << sl) - 1))
                return
            code -= 15 << sl
            p = 15
        if code < 4096:
            w.u(16, 1)
            w.u(12, code)
            return
        p = 16
        while code - (1 << (p - 3)) + 4096 >= (1 << (p - 3)):
            p += 1
        w.u(p + 1, 1)
        w.u(p - 3, code - (1 << (p - 3)) + 4096)

    def _block_cabac(self, levels, maxc, cbf_inc, cat):
        enc = self.enc
        nzpos = [i for i, v in enumerate(levels) if v]
        if cbf_inc is not None:
            enc.decision(85 + (0, 4, 8, 12, 16)[cat] + cbf_inc,
                         int(bool(nzpos)))
            if not nzpos:
                return 0
        assert nzpos
        sig_off = (0, 15, 29, 44, 47)
        abs_off = (0, 10, 20, 30, 39)
        sig_base = 402 if cat == 5 else 105 + sig_off[cat]
        last_base = 417 if cat == 5 else 166 + sig_off[cat]
        abs_base = 426 if cat == 5 else 227 + abs_off[cat]
        last = nzpos[-1]
        for i in range(maxc - 1):
            si = SIG8[i] if cat == 5 else min(i, 2) if cat == 3 else i
            li = LAST8[i] if cat == 5 else si
            sig = levels[i] != 0
            enc.decision(sig_base + si, int(sig))
            if sig:
                enc.decision(last_base + li, int(i == last))
                if i == last:
                    break
        eq1 = gt1 = 0
        for i in reversed(nzpos):
            v = abs(levels[i]) - 1
            ctx = abs_base + (0 if gt1 else min(4, 1 + eq1))
            enc.decision(ctx, int(v > 0))
            if v > 0:
                ctx = abs_base + 5 + min(4 - (cat == 3), gt1)
                k = 1
                while k < 14:
                    enc.decision(ctx, int(v > k))
                    if v <= k:
                        break
                    k += 1
                if v >= 14:
                    self._ueg(v - 14, 0)
            if v == 0:
                eq1 += 1
            else:
                gt1 += 1
            enc.bypass(int(levels[i] < 0))
        return len(nzpos)


# -------------------------------------------------------------- muxing

def annexb(units) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + n for nals, _ in units for n in nals)


def _box(typ: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), typ) + body


def _full(typ: bytes, flags: int, body: bytes) -> bytes:
    return _box(typ, struct.pack(">I", flags) + body)


def avcc(units, with_sets: bool) -> bytes:
    sps = [n for nals, _ in units for n in nals if n[0] & 31 == 7]
    pps = [n for nals, _ in units for n in nals if n[0] & 31 == 8]
    sps = list(dict.fromkeys(sps)) if with_sets else []
    pps = list(dict.fromkeys(pps)) if with_sets else []
    first = [n for nals, _ in units for n in nals if n[0] & 31 == 7][0]
    out = bytes([1, first[1], first[2], first[3], 0xFF, 0xE0 | len(sps)])
    for s in sps:
        out += struct.pack(">H", len(s)) + s
    out += bytes([len(pps)])
    for p in pps:
        out += struct.pack(">H", len(p)) + p
    if first[1] >= 100:
        out += bytes([0xFD, 0xF8, 0xF8, 0])
    return out


def write_mp4(path, units, width, height, fps, entry="avc1", ctts=False):
    """``ftyp``, ``mdat`` of length-prefixed samples, ``moov`` at the end
    (avc1: the parameter sets in ``avcC`` and out of the samples; avc3:
    in the samples)."""
    rate = Fraction(fps).limit_denominator(1001)
    timescale = rate.numerator * (100 if rate.denominator == 1 else 1)
    delta = timescale * rate.denominator // rate.numerator
    samples = []
    for nals, idr in units:
        keep = [n for n in nals if entry == "avc3" or n[0] & 31 not in (7, 8)]
        samples.append((b"".join(struct.pack(">I", len(n)) + n for n in keep),
                        idr))
    head = _box(b"ftyp", b"isom\0\0\x02\0isomiso2avc1mp41")
    mdat_start = len(head) + 8
    offsets, pos = [], mdat_start
    for s, _ in samples:
        offsets.append(pos)
        pos += len(s)
    mdat = struct.pack(">I4s", 8 + pos - mdat_start, b"mdat") + b"".join(
        s for s, _ in samples)
    n = len(samples)
    dur = n * delta
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    mdur = dur * 1000 // timescale
    mvhd = _full(b"mvhd", 0, struct.pack(">IIII", 0, 0, 1000, mdur)
                 + struct.pack(">IH10x", 0x10000, 0x100) + matrix + b"\0" * 24
                 + struct.pack(">I", 2))
    tkhd = _full(b"tkhd", 3, struct.pack(">IIIII", 0, 0, 1, 0, mdur)
                 + b"\0" * 8 + struct.pack(">hhH2x", 0, 0, 0) + matrix
                 + struct.pack(">II", width << 16, height << 16))
    mdhd = _full(b"mdhd", 0, struct.pack(">IIIIHH", 0, 0, timescale, dur,
                                         0x55C4, 0))
    hdlr = _full(b"hdlr", 0, b"\0" * 4 + b"vide" + b"\0" * 12
                 + b"VideoHandler\0")
    vmhd = _full(b"vmhd", 1, b"\0" * 8)
    dinf = _box(b"dinf", _full(b"dref", 0, struct.pack(">I", 1)
                               + _full(b"url ", 1, b"")))
    body = (b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16
            + struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1)
            + b"\0" * 32 + struct.pack(">Hh", 24, -1)
            + _box(b"avcC", avcc(units, entry == "avc1")))
    stsd = _full(b"stsd", 0, struct.pack(">I", 1) + _box(entry.encode(), body))
    stts = _full(b"stts", 0, struct.pack(">III", 1, n, delta))
    keys = [i + 1 for i, (_, k) in enumerate(samples) if k]
    stss = _full(b"stss", 0, struct.pack(">I%dI" % len(keys), len(keys),
                                         *keys))
    stsc = _full(b"stsc", 0, struct.pack(">IIII", 1, 1, 1, 1))
    stsz = _full(b"stsz", 0, struct.pack(">II%dI" % n, 0, n,
                                         *[len(s) for s, _ in samples]))
    stco = _full(b"stco", 0, struct.pack(">I%dI" % n, n, *offsets))
    stbl = stsd + stts + stss + stsc + stsz + stco
    if ctts:
        stbl += _full(b"ctts", 0, struct.pack(">III", 1, n, delta))
    stbl = _box(b"stbl", stbl)
    minf = _box(b"minf", vmhd + dinf + stbl)
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    trak = _box(b"trak", tkhd + mdia)
    moov = _box(b"moov", mvhd + trak)
    with open(path, "wb") as f:
        f.write(head + mdat + moov)


def _chunk(typ, body):
    return struct.pack("<4sI", typ, len(body)) + body + b"\0" * (len(body) & 1)


def _list(kind, body):
    return struct.pack("<4sI4s", b"LIST", 4 + len(body), kind) + body


def write_avi(path, units, width, height, fps, fourcc="H264"):
    """RIFF AVI with one video stream of Annex B access units."""
    rate = Fraction(fps).limit_denominator(1001)
    cc = fourcc.encode()
    chunks = [(b"".join(b"\x00\x00\x00\x01" + n for n in nals), idr)
              for nals, idr in units]
    n = len(chunks)
    largest = max(len(c) for c, _ in chunks)
    avih = _chunk(b"avih", struct.pack(
        "<14I", 1000000 * rate.denominator // rate.numerator, 0, 0, 0x10, n, 0,
        1, largest, width, height, 0, 0, 0, 0))
    strh = _chunk(b"strh", struct.pack(
        "<4s4sIHHIIIIIIIIhhhh", b"vids", cc, 0, 0, 0, 0, rate.denominator,
        rate.numerator, 0, n, largest, 0xFFFFFFFF, 0, 0, 0, width, height))
    strf = _chunk(b"strf", struct.pack(
        "<IiiHH4sIiiII", 40, width, height, 1, 24, cc, width * height * 3, 0,
        0, 0, 0))
    hdrl = _list(b"hdrl", avih + _list(b"strl", strh + strf))
    movi_body, index, pos = b"", [], 4
    for data, idr in chunks:
        index.append(struct.pack("<4sIII", b"00dc", 0x10 if idr else 0, pos,
                                 len(data)))
        ch = _chunk(b"00dc", data)
        movi_body += ch
        pos += len(ch)
    movi = _list(b"movi", movi_body)
    idx1 = _chunk(b"idx1", b"".join(index))
    body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def write_clip(path: str, spec: Spec):
    """Writes ``spec``'s stream to ``path`` (container by extension);
    returns the access units."""
    units = Writer(spec).units()
    ext = os.path.splitext(path)[1].lower()
    if ext in (".264", ".h264"):
        with open(path, "wb") as f:
            f.write(annexb(units))
    elif ext in (".mp4", ".mov", ".m4v"):
        write_mp4(path, units, spec.width, spec.height, spec.fps, spec.entry,
                  "ctts" in spec.forms)
    elif ext == ".avi":
        write_avi(path, units, spec.width, spec.height, spec.fps, spec.fourcc)
    else:
        raise ValueError(ext)
    return units
