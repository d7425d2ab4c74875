"""``glsdet_tpu_torch.tools.predict`` and ``tools.serve`` on the CPU.

predict: the JAX CLI (``tools/predict.py``, which reads with PIL and
draws with OpenCV) and the port's, their facades replaced by one stub
that returns the same detections, in the ``predict``, ``dir_predict``
and ``fps`` modes.  The port draws each box's outline without the label
text (the GPU machine has neither OpenCV nor a font): every pixel the
port draws equals the JAX CLI's there, but in the label boxes OpenCV
writes its text into; outside the outlines' 3-pixel band (``cv2.
rectangle`` at thickness 2) and the label boxes both images are the
input.  Then the port's real two-stage facade predicts a frame
(seeded YOLOX-nano and MP-Det-18), and ``video`` of the camera raises
naming ROADMAP item 19.

video: the JAX CLI (``cv2.VideoCapture`` and ``cv2.VideoWriter``) and the
port's (``data/video.py``) run the same clip (mp4v in .mp4 and .avi,
MJPG in .avi, written by OpenCV) through the stub: each detector receives
the same frames (``tests/test_torch_video.py``'s comparator: equal RGB),
each writer the same drawings, and both outputs read back with the same
frame count, size and fps, also with ``--max-frames`` and ``--video-fps``
and without ``--output``; a file cut before its ``moov`` exits with the
JAX CLI's message.  Then the port's seeded two-stage facade runs
``video`` on a short clip.

serve: ``archive`` writes the JAX CLI's manifest for the same arguments
(a two-stage archive, with static int8 scales); ``serve`` on a free port
in a thread, its two-stage batches served in turn on ``--devices 2``
(two handles to the CPU), answers ``client``'s POST of a PNG as the
one-device facade answers the frame; ``--devices`` parses into device
handles.
"""

import json
import os
import threading
import time
import zipfile

import cv2
import numpy as np
import pytest
import torch

import glsdet_tpu.apis  # noqa: F401  (patched by name)
import glsdet_tpu_torch.apis as tapis
from glsdet_tpu_torch.config import parse_cfg_options
from glsdet_tpu_torch.data.image_io import read_image, write_jpeg, write_png
from glsdet_tpu_torch.tools import predict, serve
from torch_tools_util import (COARSE_CLI, MP_CLI, cv2_read, cv2_write, frame,
                              run_jax, scrolling_clip)
import glsdet_tpu_torch.data.video as tvideo

NAMES = [f"class{k}" for k in range(10)]
MAKE_SERVER = serve.make_server
DRAW_THR = 0.3


class StubDetector:
    """The facades' surface, detecting the same boxes in every frame
    (scaled to it), some below the drawing threshold."""

    BOXES = np.array([[0.10, 0.20, 0.30, 0.45], [0.55, 0.50, 0.90, 0.90],
                      [0.40, 0.05, 0.60, 0.15], [0.05, 0.70, 0.20, 0.95]])
    SCORES = np.array([0.91, 0.55, 0.12, 0.33], np.float32)
    LABELS = np.array([1, 4, 2, 7])

    def __init__(self, *a, **kw):
        self.class_names = NAMES
        self.calls = 0

    def detect(self, image):
        self.calls += 1
        h, w = image.shape[:2]
        boxes = (self.BOXES * [w, h, w, h]).astype(np.float32)
        return {"boxes": boxes, "scores": self.SCORES,
                "labels": self.LABELS}


def _zones(image):
    """(outline band, label boxes) masks of the stub's drawn boxes as
    OpenCV draws them."""
    det = StubDetector().detect(image)
    band = np.zeros(image.shape[:2], np.uint8)
    label = np.zeros(image.shape[:2], bool)
    for box, score, lab in zip(det["boxes"], det["scores"], det["labels"]):
        if score < DRAW_THR:
            continue
        x1, y1, x2, y2 = (int(v) for v in box)
        cv2.rectangle(band, (x1, y1), (x2, y2), 1, 2)
        (tw, th), base = cv2.getTextSize(f"{NAMES[lab]} {score:.2f}",
                                         cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        label[max(y1 - th - 5, 0):y1 + base + 2, max(x1 - 1, 0):
              x1 + tw + 2] = True
    return band.astype(bool), label


def _check_drawn(src, got, want):
    band, label = _zones(src)
    drawn = (got != src).any(-1)
    assert drawn.sum() > 100
    assert (got == want)[drawn & ~label].all()
    assert not (drawn & ~band).any()
    outside = ~band & ~label
    assert (want == src)[outside].all() and (got == src)[outside].all()


@pytest.fixture()
def stubs(monkeypatch):
    for mod in (glsdet_tpu.apis, tapis):
        monkeypatch.setattr(mod, "Detector", StubDetector)
        monkeypatch.setattr(mod, "TwoStageDetector", StubDetector)


@pytest.mark.parametrize("two_stage", [False, True])
def test_predict_draws_as_the_jax_cli(tmp_path, stubs, two_stage):
    src = frame(3, (120, 200))
    path = str(tmp_path / "in.png")
    write_png(path, src)
    extra = ["--mp-config", "mp_det_res50"] if two_stage else []
    jout, tout = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    run_jax("predict", ["predict", path, "--output", jout, *extra])
    got = predict.main(["predict", path, "--output", tout, *extra,
                        "--device", "cpu"])
    assert got == {"images": 1, "detections": 3, "output": tout}
    _check_drawn(src, read_image(tout), read_image(jout))


def test_dir_predict_and_fps(tmp_path, stubs, capsys):
    src_dir = tmp_path / "frames"
    os.makedirs(src_dir)
    srcs = {"a": frame(4, (90, 160)), "b": frame(5, (64, 64)),
            "c": frame(6, (100, 75))}
    write_png(str(src_dir / "a.png"), srcs["a"])
    write_png(str(src_dir / "b.png"), srcs["b"])
    write_jpeg(str(src_dir / "c.jpg"), srcs["c"])
    srcs["c"] = read_image(str(src_dir / "c.jpg"))
    jdir, tdir = str(tmp_path / "jout"), str(tmp_path / "tout")
    run_jax("predict", ["dir_predict", str(src_dir), "--output", jdir])
    got = predict.main(["dir_predict", str(src_dir), "--output", tdir,
                        "--device", "cpu"])
    assert got["images"] == 3
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "a.png", "b.png", "c.png"]
    for k, src in srcs.items():
        _check_drawn(src, read_image(os.path.join(tdir, f"{k}.png")),
                     read_image(os.path.join(jdir, f"{k}.png")))
    capsys.readouterr()
    got = predict.main(["fps", str(src_dir / "a.png"), "--test-interval",
                        "3", "--device", "cpu"])
    assert got["images"] == 3 and got["fps"] > 0
    assert "3 forwards:" in capsys.readouterr().out


def test_predict_runs_the_two_stage_facade(tmp_path):
    src = frame(7, (120, 200))
    path, out = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    write_png(path, src)
    got = predict.main([
        "predict", path, "--output", out, "--mp-config", "mp_det_res50",
        "--score-thr", "0.0", "--draw-thr", "0.0", "--cfg-options",
        *COARSE_CLI, "--mp-cfg-options", *MP_CLI, "--device", "cpu"])
    drawn = read_image(out)
    assert drawn.shape == src.shape and got["detections"] > 0
    assert (drawn != src).any()
    with pytest.raises(NotImplementedError, match="item 19"):
        predict.main(["video", "0", "--device", "cpu"])


class RecordingStub(StubDetector):
    """The stub, keeping the frames each detector receives (one list a
    detector built, in ``seen``)."""

    seen = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.frames = []
        RecordingStub.seen.append(self.frames)

    def detect(self, image):
        self.frames.append(np.array(image, copy=True))
        return super().detect(image)


REAL_CV2_WRITER = cv2.VideoWriter


class Cv2Writer:
    """cv2.VideoWriter, keeping the frames written (as RGB)."""

    frames = []

    def __init__(self, *a):
        self.w = REAL_CV2_WRITER(*a)

    def write(self, bgr):
        Cv2Writer.frames.append(bgr[..., ::-1].copy())
        self.w.write(bgr)

    def release(self):
        self.w.release()


class PortWriter(tvideo.VideoWriter):
    frames = []

    def write(self, rgb):
        PortWriter.frames.append(np.array(rgb, copy=True))
        super().write(rgb)


@pytest.fixture()
def recording(monkeypatch):
    RecordingStub.seen, Cv2Writer.frames, PortWriter.frames = [], [], []
    for mod in (glsdet_tpu.apis, tapis):
        monkeypatch.setattr(mod, "Detector", RecordingStub)
        monkeypatch.setattr(mod, "TwoStageDetector", RecordingStub)
    monkeypatch.setattr(tvideo, "VideoWriter", PortWriter)
    return RecordingStub.seen


@pytest.mark.parametrize("ext,fourcc", [(".mp4", "mp4v"), (".avi", "mp4v"),
                                        (".avi", "MJPG"), (".mp4", "h264"),
                                        (".avi", "h264")])
def test_video_hands_the_jax_frames(tmp_path, recording, ext, fourcc):
    """The JAX CLI (cv2.VideoCapture) and the port hand the detector equal
    frames: clips of cv2's writer, and H.264 of tests/h264_stream.py (which
    cv2 cannot write)."""
    clip = str(tmp_path / f"clip{ext}")
    if fourcc == "h264":
        import h264_stream

        h264_stream.write_clip(clip, h264_stream.Spec(
            width=160, height=120, frames=14, fps=29.97, seed=11, refs=2,
            entropy="cabac" if ext == ".mp4" else "cavlc", t8=ext == ".mp4"))
    else:
        cv2_write(clip, scrolling_clip(121, 161, 14, seed=11), 29.97, fourcc)
    jout, tout = str(tmp_path / "j.mp4"), str(tmp_path / "t.mp4")
    run_jax("predict", ["video", clip, "--output", jout],
            **{"cv2:VideoWriter": Cv2Writer})
    got = predict.main(["video", clip, "--output", tout, "--device", "cpu"])
    assert got["frames"] == 14 and got["fps"] > 0 and got["output"] == tout
    jax_seen, port_seen = recording
    assert len(jax_seen) == len(port_seen) == 14
    for a, b in zip(jax_seen, port_seen):
        assert a.shape == b.shape == (120, 160, 3) and np.array_equal(a, b)
    assert len(Cv2Writer.frames) == len(PortWriter.frames) == 14
    for src, want, have in zip(port_seen, Cv2Writer.frames,
                               PortWriter.frames):
        _check_drawn(src, have, want)
    assert cv2_read(tout)[2:] == cv2_read(jout)[2:] == (
        29.97, 14, (160, 120))


def test_video_frame_limit_rate_and_no_output(tmp_path, recording, capsys):
    clip = str(tmp_path / "clip.mp4")
    cv2_write(clip, scrolling_clip(64, 96, 14, seed=12), 25.0)
    jout, tout = str(tmp_path / "j.avi"), str(tmp_path / "t.avi")
    opts = ["--max-frames", "5", "--video-fps", "10"]
    run_jax("predict", ["video", clip, "--output", jout, *opts],
            **{"cv2:VideoWriter": Cv2Writer})
    got = predict.main(["video", clip, "--output", tout, *opts,
                        "--device", "cpu"])
    assert got["frames"] == 5
    assert cv2_read(tout)[2:] == cv2_read(jout)[2:] == (10.0, 5, (96, 64))
    capsys.readouterr()
    run_jax("predict", ["video", clip], **{"cv2:VideoWriter": Cv2Writer})
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    got = predict.main(["video", clip, "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got["frames"] == 14 and got["output"] is None
    assert jline.startswith("14 frames in ") and line.startswith(
        "14 frames in ") and "->" not in line + jline
    assert [len(s) for s in recording] == [5, 5, 14, 14]


def test_video_of_a_cut_file_exits_as_the_jax_cli(tmp_path, recording):
    clip = str(tmp_path / "clip.mp4")
    cv2_write(clip, scrolling_clip(48, 64, 4), 25.0)
    b = open(clip, "rb").read()
    open(clip, "wb").write(b[:b.index(b"moov") - 4])
    with pytest.raises(SystemExit) as jerr:
        run_jax("predict", ["video", clip])
    with pytest.raises(SystemExit) as err:
        predict.main(["video", clip, "--device", "cpu"])
    assert err.value.code == jerr.value.code == (
        f"cannot open video source {clip!r}")


def test_video_runs_the_two_stage_facade(tmp_path):
    clip, out = str(tmp_path / "clip.avi"), str(tmp_path / "out.mp4")
    frames = scrolling_clip(120, 200, 3, seed=13)
    with tvideo.VideoWriter(clip, 25.0, (200, 120)) as w:
        for f in frames:
            w.write(f)
    got = predict.main([
        "video", clip, "--output", out, "--mp-config", "mp_det_res50",
        "--score-thr", "0.0", "--draw-thr", "0.0", "--cfg-options",
        *COARSE_CLI, "--mp-cfg-options", *MP_CLI, "--device", "cpu"])
    assert got["frames"] == 3
    src = list(tvideo.VideoReader(clip))
    drawn = list(tvideo.VideoReader(out))
    assert len(drawn) == 3 and drawn[0].shape == (120, 200, 3)
    assert any((d.astype(int) - s).any() for d, s in zip(drawn, src))


def _manifest(path):
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read("MANIFEST.json")), sorted(zf.namelist())


def test_archive_serve_client(tmp_path):
    scales = str(tmp_path / "scales.json")
    with open(scales, "w") as f:
        json.dump({"format": "glsdet-int8-scales-v1", "coarse": {"a": 1.0},
                   "mp": {"b": 2.0}}, f)
    argv = ["archive", "--config", "coarse_det", "--mp-config",
            "mp_det_res50", "--model-name", "ufpmp", "--score-thr", "0.0",
            "--cfg-options", *COARSE_CLI, "--mp-cfg-options", *MP_CLI]
    for k, extra in enumerate(
            (["--no-fuse-global"], ["--int8", "static", "--int8-scales",
                                    scales])):
        jpath = str(tmp_path / f"j{k}.gtar")
        run_jax("serve", [*argv, *extra, "--output", jpath])
        tpath = serve.main([*argv, *extra, "--output",
                            str(tmp_path / "store" / f"t{k}")])
        assert tpath.endswith(".gtar")
        assert _manifest(tpath) == _manifest(jpath)
    os.remove(str(tmp_path / "store" / "t1.gtar"))

    cpu = torch.device("cpu")
    assert serve.serving_devices("2", "cpu") == [cpu, cpu]
    assert serve.serving_devices("all", "cpu") == [cpu]
    with pytest.raises(ValueError, match="count"):
        serve.serving_devices("0", "cpu")

    servers = []

    def capture(service, host, port):
        servers.append(MAKE_SERVER(service, host, port))
        return servers[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "make_server", capture)
        thread = threading.Thread(target=serve.main, args=([
            "serve", "--model-store", str(tmp_path / "store"), "--port",
            "0", "--devices", "2", "--device", "cpu"],), daemon=True)
        thread.start()
        for _ in range(600):
            if servers or not thread.is_alive():
                break
            time.sleep(0.1)
    assert servers, "the server did not start"
    src = frame(8, (120, 200))
    img = str(tmp_path / "req.png")
    write_png(img, src)
    try:
        port = servers[0].server_address[1]
        dets = serve.main(["client", img, "--url",
                           f"http://127.0.0.1:{port}"])
    finally:
        servers[0].shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
    want = tapis.TwoStageDetector(
        "coarse_det", None, "mp_det_res50", None, score_thr=0.0,
        fuse_global=False, coarse_options=parse_cfg_options(COARSE_CLI),
        mp_options=parse_cfg_options(MP_CLI), device="cpu").detect(src)
    assert len(dets) == len(want["boxes"]) > 0
    for d, box, label in zip(dets, want["boxes"], want["labels"]):
        assert d["class_label"] == int(label)
        np.testing.assert_allclose(d["bbox"], box, atol=0.01)
