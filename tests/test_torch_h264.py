"""H.264 decoding of ``glsdet_tpu_torch.data.video`` (``native/h264.cpp``)
on the CPU, held against OpenCV's FFmpeg backend.

Every fixture is written at test time by ``tests/h264_stream.py``: seeded
streams whose syntax is drawn at random per macroblock (frames up to
176x144, a few each), in raw Annex B, ``.mp4`` (``avc1`` and ``avc3``)
and ``.avi``.  For each one ``cv2.VideoCapture`` opens it and returns
every frame written, and the port's luma planes, RGB frames (envelope 0),
frame count, size and fps equal cv2's under ``tests/test_torch_video.py``'s
comparator.  Between them the fixtures reach every tool ``h264.cpp``
counts.  A stream whose VUI names another colour matrix than BT.601 is
compared by its RGB frames; its planes are held to those of the same
stream without the colour description, which cv2 returns as they are
(with another matrix OpenCV's raw frame is a colour-converted grey).

Each form ``h264.cpp`` leaves to ROADMAP item 19 raises
``NotImplementedError`` naming it when the reader opens the file, before
any frame; a stream that breaks the syntax raises ``ValueError``.
"""

import dataclasses

import cv2
import numpy as np
import pytest

import h264_stream as hs
from glsdet_tpu_torch.data.video import H264_TOOLS, VideoReader
from test_torch_video import assert_same_frames, port_read
from torch_tools_util import cv2_read

S = hs.Spec
FIXTURES = {
    # Baseline CAVLC: POC type 2, several slices, deblocking idc 0/1/2,
    # constrained intra, non-reference pictures, a non-IDR I picture
    "baseline_cavlc": (S(width=176, height=144, frames=5, profile=66,
                         refs=2, listmod=True, slices=4, deblock=(0, 1, 2),
                         constrained=True, nonref=0.3, i_every=3,
                         poc_types=(2,), seed=1), ".264"),
    # Main CABAC: explicit weights, several references, list modification
    "main_cabac": (S(width=96, height=64, frames=6, profile=77,
                     entropy="cabac", refs=3, listmod=True, weighted=True,
                     slices=2, deblock=(0, 2), seed=2), ".mp4"),
    # High CABAC: 8x8 transforms, matrices in the SPS and the PPS,
    # low QPs and large levels
    "high_cabac_8x8": (S(width=80, height=48, frames=5, entropy="cabac",
                         t8=True, scaling="both", refs=2, escapes=True,
                         qp=(10, 40), seed=3), ".mp4"),
    # High CAVLC: 8x8 transforms, PPS matrices, level escapes, P_8x8ref0
    "high_cavlc_8x8": (S(width=80, height=64, frames=5, t8=True,
                         scaling="pps", refs=3, escapes=True, weighted=True,
                         seed=4, fps=29.97), ".avi"),
    # both coders in one stream, parameter sets changing between pictures,
    # IDRs switching SPS (POC types 1, 0, 2), AUD/SEI/filler/SVC units
    "mixed_changing_sets": (S(width=64, height=48, frames=9,
                              entropy="mixed", idr_every=3,
                              poc_types=(1, 0, 2), change_pps=True,
                              extra_nals=True, refs=2, t8=True, seed=5,
                              entry="avc3"), ".mp4"),
    # cropping (1360x764 coded as 1360x768, here 60x44 as 64x48), full
    # range
    "cropped_full_range": (S(width=60, height=44, crop=(0, 0, 2, 0),
                             frames=4, full_range=True, entropy="cabac",
                             seed=6), ".264"),
    "limited_range_vui": (S(width=48, height=32, frames=4,
                            full_range=False, pcm=0.2, seed=7,
                            fourcc="X264"), ".avi"),
    "cabac_pcm_skip": (S(width=64, height=48, frames=6, entropy="cabac",
                         pcm=0.15, skip=0.6, seed=8, profile=77,
                         poc_types=(1,)), ".264"),
    "cavlc_qp_wraps": (S(width=64, height=48, frames=4, qp=(0, 51),
                         seed=9, deblock=(0, 2), fourcc="h264"), ".avi"),
}
MATRIX_FIXTURES = {  # RGB through the matrix the VUI names
    "bt709": (S(width=48, height=32, frames=3, full_range=False, matrix=1,
                seed=10), ".264"),
    "bt709_full": (S(width=48, height=32, frames=3, full_range=True,
                     matrix=1, entropy="cabac", seed=11), ".mp4"),
    "fcc": (S(width=32, height=32, frames=2, full_range=False, matrix=4,
              seed=12), ".264"),
    "smpte240m": (S(width=32, height=32, frames=2, full_range=False,
                    matrix=7, seed=13), ".264"),
    "bt2020": (S(width=32, height=32, frames=2, full_range=False, matrix=9,
                 seed=14), ".264"),
}


def _write(tmp_path, name, spec, ext):
    path = str(tmp_path / f"{name}{ext}")
    hs.write_clip(path, spec)
    return path


def assert_same(got, want, n):
    """``assert_same_frames`` with ``n`` frames read: a raw stream's
    reported count (equal on both sides) is not its number of frames."""
    assert got[3] == want[3]
    assert_same_frames((*got[:3], n, got[4]), (*want[:3], n, want[4]))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_planes_equal_cv2(tmp_path, name):
    spec, ext = FIXTURES[name]
    path = _write(tmp_path, name, spec, ext)
    want = cv2_read(path)
    assert len(want[0]) == spec.frames  # cv2 returns every frame written
    assert want[4] == (spec.width, spec.height)
    assert_same(port_read(path), want, spec.frames)


@pytest.mark.parametrize("name", sorted(MATRIX_FIXTURES))
def test_rgb_through_the_vui_matrix(tmp_path, name):
    spec, ext = MATRIX_FIXTURES[name]
    path = _write(tmp_path, name, spec, ext)
    plain = _write(tmp_path, "plain", dataclasses.replace(spec, matrix=None),
                   ext)
    rgb, _, fps, count, size = cv2_read(path)
    got = port_read(path)
    assert len(rgb) == spec.frames and got[2:] == (fps, count, size)
    for a, b in zip(got[0], rgb):
        assert np.abs(a.astype(int) - b).max() == 0
    # the planes do not depend on the colour description, and cv2 returns
    # the untagged stream's as they are
    twin = cv2_read(plain)
    assert all(np.array_equal(a, b) for a, b in zip(got[1], twin[1]))
    assert len(got[1]) == len(twin[1]) == spec.frames


def test_fixtures_reach_every_tool(tmp_path):
    seen = dict.fromkeys(H264_TOOLS, 0)
    for name, (spec, ext) in FIXTURES.items():
        path = _write(tmp_path, name, spec, ext)
        with VideoReader(path) as r:
            n = sum(1 for _ in r.planes())
            assert n == spec.frames
            for k, v in r.tools().items():
                seen[k] += v
    assert all(v > 0 for v in seen.values()), {
        k: v for k, v in seen.items() if not v}


def test_raw_stream_count_and_fps_as_cv2(tmp_path):
    """cv2 gives a raw Annex B file FFmpeg's default 25 fps and a frame
    count made of an unknown duration; the port reports the same."""
    spec = S(width=32, height=32, frames=3, seed=15)
    path = _write(tmp_path, "raw", spec, ".h264")
    cap = cv2.VideoCapture(path)
    want = (cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
    cap.release()
    with VideoReader(path) as r:
        assert (r.fps, r.frame_count) == want
        assert len(list(r)) == 3


@pytest.mark.parametrize("form", sorted(hs.FORMS))
def test_refuses_item_19_forms_before_any_frame(tmp_path, form):
    profile = {"lossless": 244, "chroma422": 122, "bit_depth": 110}.get(
        form, 100)
    spec = S(width=48, height=32, frames=4, refs=2, forms=(form,),
             profile=profile, seed=16)
    path = _write(tmp_path, form, spec, ".mp4" if form == "ctts" else ".264")
    with pytest.raises(NotImplementedError, match="item 19"):
        VideoReader(path)


def _nal_positions(b):
    out, i = [], b.find(b"\x00\x00\x01")
    while i >= 0:
        out.append(i + 3)
        i = b.find(b"\x00\x00\x01", i + 3)
    return out


@pytest.mark.parametrize("how", ["cut_slice", "forbidden_bit",
                                 "missing_pps", "garbled_slice"])
def test_corrupt_syntax_raises_value_error(tmp_path, how):
    spec = S(width=48, height=32, frames=3, seed=17,
             entropy="cabac" if how == "garbled_slice" else "cavlc")
    path = _write(tmp_path, "ok", spec, ".264")
    b = bytearray(open(path, "rb").read())
    pos = _nal_positions(bytes(b))
    slices = [p for p in pos if b[p] & 31 in (1, 5)]
    if how == "cut_slice":  # the last picture's slice, cut in half
        b = b[:slices[-1] + (len(b) - slices[-1]) // 2]
    elif how == "forbidden_bit":
        b[slices[1]] |= 0x80
    elif how == "missing_pps":
        for p in pos:
            if b[p] & 31 == 8:
                b[p] = (b[p] & 0xE0) | 12  # filler in its place
    else:  # CABAC data of the second picture overwritten
        end = slices[2] - 4
        n = end - slices[1] - 6
        b[slices[1] + 6:end] = ((np.arange(n) * 37 + 7) % 256).astype(
            np.uint8).tobytes()
    bad = str(tmp_path / "bad.264")
    open(bad, "wb").write(bytes(b))
    with pytest.raises(ValueError, match="corrupt video"):
        with VideoReader(bad) as r:
            list(r)


def test_chip_smoke_h264_digests(tmp_path):
    """The card machine has no OpenCV: ``chip_smoke.py``'s ``h264`` phase
    holds the writer's clips and the port's decode of them to digests
    recorded here, and here OpenCV decodes the same files to the same
    frames."""
    import chip_smoke

    host = chip_smoke.h264_host(str(tmp_path))
    assert host["sha256"] == chip_smoke.H264_SHA256
    hw = chip_smoke.H264_HW
    for name, path in host["paths"].items():
        rgb, _, fps, count, size = cv2_read(path)
        assert (fps, count, size) == (chip_smoke.H264_FPS,
                                      chip_smoke.H264_FRAMES, (hw[1], hw[0]))
        assert chip_smoke.sha256([np.ascontiguousarray(f) for f in rgb]) == (
            host["sha256"][name]["decoded"])
