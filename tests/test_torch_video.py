"""``glsdet_tpu_torch.data.video`` and ``data/video_container.py`` on the
CPU, held against OpenCV's FFmpeg backend.

Clips are written at test time into ``tmp_path``: by ``cv2.VideoWriter``
(fourcc ``mp4v`` in ``.mp4`` and ``.avi``, ``XVID`` in ``.avi``, ``MJPG``
in ``.avi`` and ``.mov``) and by the port's ``VideoWriter``, from seeded
frames that scroll a few pixels a frame (P-VOPs with motion), 16 frames
(a second I-VOP at 12) at 176x144 and 161x121 and 4 at VisDrone's
1360x765.

The comparator: the port's luma planes equal ``cv2.VideoCapture``'s with
``CAP_PROP_CONVERT_RGB`` 0 bit for bit, and its RGB frames equal
``cv2.VideoCapture``'s BGR frames reversed within ``RGB_ENVELOPE`` (0:
swscale's x86 yuv2rgb is repeated exactly); frame count, size (161x121 and
1360x765 written read back as 160x120 and 1360x764) and fps (25, 29.97)
equal ``cv2.VideoCapture``'s.  cv2 reads the port's files with the count,
size and fps its own ``mp4v`` writer gives, decodes them to the port's own
frames, at a mean PSNR no lower than its writer's and no more than twice
its size.  H.264 in ``avc1``/``avc3`` entries and ``H264``/``X264`` AVIs
decodes to cv2's frames (``tests/test_torch_h264.py`` holds the rest of
H.264).  HEVC and other codecs, B-VOPs, quarter-pel and the other MPEG-4
tools the decoder does not handle, XviD-tagged streams, other containers,
an edit list, an OpenDML extension and an AVI past 1 GiB raise
``NotImplementedError`` naming item 19; a file cut before its ``moov``
raises ``VideoOpenError``.
"""

import os
import struct

import cv2
import numpy as np
import pytest

from glsdet_tpu_torch.data import video_container
from glsdet_tpu_torch.data.video import VideoReader, VideoWriter
from glsdet_tpu_torch.data.video_container import (Mp4Writer, VideoOpenError,
                                                   frame_rate, open_track)
from torch_tools_util import cv2_read, cv2_write, scrolling_clip

RGB_ENVELOPE = 0
SMALL = [((144, 176), 25.0), ((144, 176), 29.97), ((121, 161), 25.0),
         ((121, 161), 29.97)]
FORMATS = [(".mp4", "mp4v"), (".avi", "mp4v"), (".avi", "MJPG")]
READ_CASES = ([(ext, cc, hw, fps, 16) for ext, cc in FORMATS
               for hw, fps in SMALL]
              + [(ext, cc, (765, 1360), 29.97, 4) for ext, cc in FORMATS]
              + [(".avi", "XVID", (144, 176), 25.0, 16),
                 (".mov", "MJPG", (121, 161), 29.97, 16)])


def port_read(path):
    with VideoReader(path) as r:
        planes = [(y.copy(), u.copy(), v.copy()) for y, u, v in r.planes()]
    with VideoReader(path) as r:
        rgb = list(r)
        meta = (r.fps, r.frame_count, (r.width, r.height))
    return (rgb, [p[0] for p in planes], *meta)


def assert_same_frames(got, want):
    rgb, luma, fps, count, size = got
    wrgb, wluma, wfps, wcount, wsize = want
    assert (fps, count, size) == (wfps, wcount, wsize)
    assert len(rgb) == len(wrgb) == len(luma) == len(wluma) == count
    for a, b in zip(luma, wluma):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    for a, b in zip(rgb, wrgb):
        assert a.shape == b.shape == (size[1], size[0], 3)
        assert a.flags.c_contiguous
        assert np.abs(a.astype(int) - b).max() <= RGB_ENVELOPE


@pytest.mark.parametrize("ext,fourcc,hw,fps,n", READ_CASES,
                         ids=lambda v: str(v))
def test_reads_the_frames_cv2_reads(tmp_path, ext, fourcc, hw, fps, n):
    path = str(tmp_path / f"clip{ext}")
    cv2_write(path, scrolling_clip(*hw, n, seed=hw[1]), fps, fourcc)
    want = cv2_read(path)
    assert want[3] == n and want[4] == (hw[1] & ~1, hw[0] & ~1)
    assert_same_frames(port_read(path), want)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("ext", [".mp4", ".avi"])
@pytest.mark.parametrize("hw,fps,n", [((144, 176), 25.0, 16),
                                      ((121, 161), 29.97, 16),
                                      ((765, 1360), 29.97, 4)])
def test_writes_what_cv2_reads(tmp_path, ext, hw, fps, n):
    frames = scrolling_clip(*hw, n, seed=7)
    mine, theirs = str(tmp_path / f"port{ext}"), str(tmp_path / f"cv2{ext}")
    with VideoWriter(mine, fps, (hw[1], hw[0])) as w:
        for f in frames:
            w.write(f)
    cv2_write(theirs, frames, fps)
    got, ref = cv2_read(mine), cv2_read(theirs)
    assert got[2:] == ref[2:]  # fps, count, size
    # cv2 decodes the port's file to the port's own frames
    assert_same_frames(port_read(mine), got)
    h, w = ref[4][1], ref[4][0]
    mean_psnr = [np.mean([psnr(a, f[:h, :w]) for a, f in zip(d[0], frames)])
                 for d in (got, ref)]
    assert mean_psnr[0] >= mean_psnr[1]
    assert os.path.getsize(mine) <= 2 * os.path.getsize(theirs)


def test_fixtures_cover_every_decoder_tool(tmp_path):
    """Between them, a clip of cv2's writer and one of the port's (which
    cv2 decodes to the port's frames above) reach every MPEG-4 tool the
    decoder accepts: intra MBs in P-VOPs, not-coded MBs, DQUANT, AC
    prediction (from neighbours quantised otherwise too) and the three
    escapes."""
    frames = scrolling_clip(121, 161, 16, seed=7)
    theirs, mine = str(tmp_path / "cv2.mp4"), str(tmp_path / "port.mp4")
    cv2_write(theirs, frames, 25.0)
    with VideoWriter(mine, 25.0, (161, 121)) as w:
        for f in frames:
            w.write(f)
    seen = {}
    for path in (theirs, mine):
        with VideoReader(path) as r:
            for _ in r:
                pass
            for k, v in r.tools().items():
                seen[k] = seen.get(k, 0) + v
    assert seen["i_vops"] == 4 and seen["p_vops"] == 28
    assert all(v > 0 for v in seen.values()), seen


def _boxes(b, pos, end):
    while pos < end:
        size, typ = struct.unpack(">I4s", b[pos:pos + 8])
        if size == 1:  # a 64-bit size follows
            size = struct.unpack(">Q", b[pos + 8:pos + 16])[0]
        yield typ, pos, pos + size
        pos += size


def _find(b, path):
    """(start, end) of the box at ``path`` (types from the root down)."""
    start, end = 0, len(b)
    for typ in path:
        start, end = next((s + 8, e) for t, s, e in _boxes(b, start, end)
                          if t == typ)
    return start, end


def test_container_fields(tmp_path):
    frames = scrolling_clip(48, 64, 14, seed=1)
    mp4, avi = str(tmp_path / "a.mp4"), str(tmp_path / "a.avi")
    for path in (mp4, avi):
        with VideoWriter(path, 29.97, (64, 48)) as w:
            for f in frames:
                w.write(f)
    b = open(mp4, "rb").read()
    assert [t for t, _, _ in _boxes(b, 0, len(b))][-2:] == [b"mdat", b"moov"]
    stbl = (b"moov", b"trak", b"mdia", b"minf", b"stbl")
    s, _ = _find(b, (b"moov", b"trak", b"mdia", b"mdhd"))
    assert struct.unpack(">I", b[s + 12:s + 16])[0] == 11988
    s, _ = _find(b, (*stbl, b"stts"))
    assert struct.unpack(">III", b[s + 4:s + 16]) == (1, 14, 400)
    s, _ = _find(b, (*stbl, b"stss"))
    assert struct.unpack(">III", b[s + 4:s + 16]) == (2, 1, 13)
    t = open_track(mp4)
    assert t.config.startswith(b"\x00\x00\x01\xb0")
    assert t.fps == 29.97 and t.keyframes.nonzero()[0].tolist() == [0, 12]
    assert frame_rate(29.97) == frame_rate(29.970001) != frame_rate(30.0)
    a = open_track(avi)
    assert (a.fourcc, a.fps, a.frame_count) == ("FMP4", 29.97, 14)
    assert a.keyframes.nonzero()[0].tolist() == [0, 12]
    assert cv2_read(avi)[2:] == (29.97, 14, (64, 48))
    # past 4 GiB the chunk offsets are 64-bit
    w = Mp4Writer(str(tmp_path / "big.mp4"), 64, 48, frame_rate(25.0), b"")
    w.add(b"\0" * 8, True)
    w.offsets[0] += 1 << 32
    assert b"co64" in w._moov() and b"stco" not in w._moov()
    w.close()


def _cv2_clip(tmp_path, ext=".mp4", fourcc="mp4v", n=14):
    path = str(tmp_path / f"src{ext}")
    cv2_write(path, scrolling_clip(48, 64, n, seed=3), 25.0, fourcc)
    return path, open(path, "rb").read()


def _h264_clip(tmp_path, ext, **kw):
    """An H.264 clip of ``tests/h264_stream.py``, 14 frames at 64x48."""
    import h264_stream

    path = str(tmp_path / f"h264{ext}")
    h264_stream.write_clip(path, h264_stream.Spec(
        width=64, height=48, frames=14, seed=3, refs=2, **kw))
    return path


@pytest.mark.parametrize("entry", [b"avc1", b"avc3", b"hvc1", b"hev1"])
def test_refuses_other_codecs_in_mp4(tmp_path, entry):
    """H.264 (avc1, avc3) decodes to cv2's frames; HEVC is refused."""
    if entry in (b"avc1", b"avc3"):
        path = _h264_clip(tmp_path, ".mp4", entry=entry.decode(),
                          entropy="cabac")
        assert open_track(path).fourcc == entry.decode()
        assert_same_frames(port_read(path), cv2_read(path))
        return
    path, b = _cv2_clip(tmp_path)
    i = b.index(b"mp4v")
    patched = str(tmp_path / "h26x.mp4")
    open(patched, "wb").write(b[:i] + entry + b[i + 4:])
    with pytest.raises(NotImplementedError, match="item 19"):
        VideoReader(patched)


@pytest.mark.parametrize("fourcc", [b"H264", b"X264", b"HEVC"])
def test_refuses_other_codecs_in_avi(tmp_path, fourcc):
    """H.264 (H264, X264) decodes to cv2's frames; HEVC is refused."""
    if fourcc != b"HEVC":
        path = _h264_clip(tmp_path, ".avi", fourcc=fourcc.decode())
        assert open_track(path).fourcc == fourcc.decode()
        assert_same_frames(port_read(path), cv2_read(path))
        return
    path, b = _cv2_clip(tmp_path, ".avi")
    patched = str(tmp_path / "h26x.avi")
    open(patched, "wb").write(b.replace(b"mp4v", fourcc))
    with pytest.raises(NotImplementedError, match="item 19"):
        VideoReader(patched)


def _bits(fields):
    """(value, width) fields -> bytes, padded with next_start_code's
    stuffing (a zero, then ones)."""
    s = "".join(format(v, f"0{n}b") for v, n in fields)
    s += "0" + "1" * ((-len(s) - 1) % 8)
    return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


def _vol(w, h, res, verid=2, **flags):
    """A VOL of ``verid`` with the tools in ``flags`` switched on."""
    f = dict(interlaced=0, obmc_disable=1, sprite=0, quant_type=0,
             quarter_sample=0, resync_marker_disable=1, data_partitioned=0)
    f.update(flags)
    fields = [(0, 1), (1, 8), (1, 1), (verid, 4), (1, 3), (1, 4), (1, 1),
              (1, 2), (1, 1), (0, 1), (0, 2), (1, 1), (res, 16), (1, 1),
              (0, 1), (1, 1), (w, 13), (1, 1), (h, 13), (1, 1),
              (f["interlaced"], 1), (f["obmc_disable"], 1),
              (f["sprite"], 1 if verid == 1 else 2), (0, 1),
              (f["quant_type"], 1)]
    if verid != 1:
        fields.append((f["quarter_sample"], 1))
    fields += [(1, 1), (f["resync_marker_disable"], 1),
               (f["data_partitioned"], 1)]
    if f["data_partitioned"]:
        fields.append((0, 1))
    if verid != 1:
        fields += [(0, 1), (0, 1)]
    fields.append((0, 1))
    return (b"\x00\x00\x01\xb0\x01\x00\x00\x01\xb5\x09\x00\x00\x01\x00"
            b"\x00\x00\x01\x20" + _bits(fields))


def _remux(tmp_path, src, config, name="patched.mp4"):
    """The samples of ``src`` in a new .mp4 whose esds holds ``config``."""
    t = open_track(src)
    path = str(tmp_path / name)
    w = Mp4Writer(path, t.width, t.height, frame_rate(t.fps), config)
    for data, key in zip(t.samples(), t.keyframes):
        w.add(data, bool(key))
    w.close()
    return path


def test_a_rewritten_vol_decodes_as_before(tmp_path):
    """The test's VOL writer, with no tool switched on, gives the frames
    cv2's own VOL gives (so the refusals below change one flag only)."""
    src, _ = _cv2_clip(tmp_path)
    path = _remux(tmp_path, src, _vol(64, 48, 25))
    a, b = port_read(path), port_read(src)
    assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
    assert len(a[0]) == 14


@pytest.mark.parametrize("flag,what", [
    ("quarter_sample", "quarter-pel"), ("interlaced", "interlaced"),
    ("sprite", "sprites"), ("data_partitioned", "data partitioning"),
    ("quant_type", "MPEG quantisation"), ("obmc_disable", "overlapped"),
    ("resync_marker_disable", "resync")])
def test_refuses_mpeg4_tools_in_the_vol(tmp_path, flag, what):
    src, _ = _cv2_clip(tmp_path)
    on = 0 if flag in ("obmc_disable", "resync_marker_disable") else 1
    path = _remux(tmp_path, src, _vol(64, 48, 25, **{flag: on}))
    with pytest.raises(NotImplementedError, match=f"{what}.*item 19"):
        VideoReader(path)


@pytest.mark.parametrize("kind,what", [(2, "B-VOP"), (3, "S \\(sprite")])
def test_refuses_b_and_s_vops_before_any_frame(tmp_path, kind, what):
    path, b = _cv2_clip(tmp_path)
    t = open_track(path)
    off = int(t.offsets[5])  # a P-VOP
    k = b.index(b"\x00\x00\x01\xb6", off) + 4
    patched = bytearray(b)
    patched[k] = (patched[k] & 0x3F) | (kind << 6)
    out = str(tmp_path / "bvop.mp4")
    open(out, "wb").write(bytes(patched))
    with pytest.raises(NotImplementedError, match=f"sample 5 is a {what}"):
        VideoReader(out)


def test_refuses_xvid_and_divx_tagged_streams(tmp_path):
    path, b = _cv2_clip(tmp_path, ".avi")
    for tag in (b"XviD", b"DivX"):
        out = str(tmp_path / "tagged.avi")
        open(out, "wb").write(b.replace(b"Lavc", tag))
        with pytest.raises(NotImplementedError, match="item 19"):
            list(VideoReader(out))
    # an untagged stream in an AVI marked XVID is XviD's to FFmpeg
    out = str(tmp_path / "untagged.avi")
    with VideoWriter(out, 25.0, (64, 48)) as w:
        for f in scrolling_clip(48, 64, 2):
            w.write(f)
    b = open(out, "rb").read()
    open(out, "wb").write(b.replace(b"FMP4", b"XVID"))
    with pytest.raises(NotImplementedError, match="XVID.*item 19"):
        VideoReader(out)


def test_refuses_other_containers_and_edits(tmp_path):
    mkv = str(tmp_path / "a.mkv")
    open(mkv, "wb").write(b"\x1a\x45\xdf\xa3" + b"\0" * 64)
    with pytest.raises(NotImplementedError, match="Matroska.*item 19"):
        VideoReader(mkv)
    junk = str(tmp_path / "a.bin")
    open(junk, "wb").write(b"not a video at all")
    with pytest.raises(VideoOpenError):
        VideoReader(junk)
    with pytest.raises(VideoOpenError):
        VideoReader(str(tmp_path / "missing.mp4"))
    path, b = _cv2_clip(tmp_path)
    s, _ = _find(b, (b"moov", b"trak", b"edts", b"elst"))
    patched = bytearray(b)
    patched[s + 12:s + 16] = struct.pack(">i", 512)  # media_time
    out = str(tmp_path / "edited.mp4")
    open(out, "wb").write(bytes(patched))
    with pytest.raises(NotImplementedError, match="edit list.*item 19"):
        VideoReader(out)
    with pytest.raises(NotImplementedError, match="item 19"):
        VideoWriter(str(tmp_path / "out.mkv"), 25.0, (64, 48))


def test_refuses_a_file_cut_before_its_moov(tmp_path):
    path, b = _cv2_clip(tmp_path)
    cut = str(tmp_path / "cut.mp4")
    open(cut, "wb").write(b[:b.index(b"moov") - 4])
    with pytest.raises(VideoOpenError, match="moov"):
        VideoReader(cut)
    assert not cv2.VideoCapture(cut).isOpened()


def test_opendml_past_one_gib(tmp_path, monkeypatch):
    path, b = _cv2_clip(tmp_path, ".avi")
    out = str(tmp_path / "avix.avi")
    open(out, "wb").write(b + b"RIFF" + struct.pack("<I", 4) + b"AVIX")
    with pytest.raises(NotImplementedError, match="AVIX.*item 19"):
        VideoReader(out)
    monkeypatch.setattr(video_container, "_AVI_MAX", 3000)
    w = VideoWriter(str(tmp_path / "big.avi"), 25.0, (64, 48))
    with pytest.raises(NotImplementedError, match="1 GiB.*item 19"):
        for f in scrolling_clip(48, 64, 40):
            w.write(f)
    w.close()


def test_chip_smoke_video_digests(tmp_path):
    """The card machine has no OpenCV: ``chip_smoke.py``'s ``video``
    phase holds the port's host codec to digests recorded here, and here
    OpenCV decodes the same files to the same frames."""
    import chip_smoke
    from torch_tools_util import scrolling_clip

    frames = chip_smoke.video_clip(*chip_smoke.FRAME_HW,
                                   chip_smoke.VIDEO_FRAMES,
                                   chip_smoke.VIDEO_SEED)
    assert all(np.array_equal(a, b) for a, b in zip(frames, scrolling_clip(
        *chip_smoke.FRAME_HW, chip_smoke.VIDEO_FRAMES,
        chip_smoke.VIDEO_SEED)))
    host = chip_smoke.video_host(str(tmp_path))
    assert host["sha256"] == chip_smoke.VIDEO_SHA256
    for path in host["paths"].values():
        rgb, _, fps, count, size = cv2_read(path)
        assert (fps, count, size) == (25.0, 24, (1360, 764))
        assert chip_smoke.sha256(
            [np.ascontiguousarray(f) for f in rgb]) == host["sha256"][
                "decoded"]
