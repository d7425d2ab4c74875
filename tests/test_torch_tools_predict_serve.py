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
(seeded YOLOX-nano and MP-Det-18), and ``video`` raises naming ROADMAP
item 19.

serve: ``archive`` writes the JAX CLI's manifest for the same arguments
(a two-stage archive, with static int8 scales); ``serve`` on a free port
in a thread answers ``client``'s POST of a PNG as the facade answers the
frame; ``--devices`` raises naming item 6.
"""

import json
import os
import threading
import time
import zipfile

import cv2
import numpy as np
import pytest

import glsdet_tpu.apis  # noqa: F401  (patched by name)
import glsdet_tpu_torch.apis as tapis
from glsdet_tpu_torch.config import parse_cfg_options
from glsdet_tpu_torch.data.image_io import read_image, write_jpeg, write_png
from glsdet_tpu_torch.tools import predict, serve
from torch_tools_util import COARSE_CLI, MP_CLI, frame, run_jax

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

    with pytest.raises(NotImplementedError, match="item 6"):
        serve.main(["serve", "--model-store", str(tmp_path / "store"),
                    "--devices", "2", "--device", "cpu"])

    servers = []

    def capture(service, host, port):
        servers.append(MAKE_SERVER(service, host, port))
        return servers[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "make_server", capture)
        thread = threading.Thread(target=serve.main, args=([
            "serve", "--model-store", str(tmp_path / "store"), "--port",
            "0", "--device", "cpu"],), daemon=True)
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
