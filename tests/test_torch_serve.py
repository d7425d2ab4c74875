"""The port's serving layer (``glsdet_tpu_torch/serve.py``) on the CPU:
the HTTP service, the async batcher and the model archive.

The facades are the port's own at test size (YOLOX-nano at 64x64, MP-Det
depth 18, buckets (128, 256), coarse threshold 1e-4, seeded weights
written to state-dict files).  Results that went through a batch of
another composition are matched at tests/test_torch_two_stage.py's
tolerances (same label, boxes within 1e-4, scores within 1e-6, one to
one): the CPU convolutions sum a batch of 2 in another order than a
batch of 3.  Archive manifests must equal the JAX package's for the
same arguments.
"""

import base64
import json
import os
import sys
import threading
import urllib.error
import urllib.request
import zipfile
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
import torch

import glsdet_tpu.serve as jserve
from glsdet_tpu_torch import apis, serve
from glsdet_tpu_torch.config import apply_overrides, get_config
from glsdet_tpu_torch.models.build import build_model

COARSE_OPTS = {"model.phi": "nano", "data.img_hw": (64, 64),
               "eval.coarse_score_thr": 1e-4,
               "eval.mosaic_buckets": (128, 256)}
MP_OPTS = {"model.depth": 18}
DET_OPTS = {"model.phi": "nano", "data.img_hw": (64, 64),
            "eval.score_thr": 1e-4}
FRAME = (96, 160)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name, opts, seed in (("coarse_det", COARSE_OPTS, 1),
                             ("mp_det_res50", MP_OPTS, 2)):
        cfg = apply_overrides(get_config(name), dict(opts))
        model = build_model(cfg, "cpu", torch.Generator().manual_seed(seed))
        out[name] = str(d / f"{name}.pt")
        torch.save(model.state_dict(), out[name])
    return out


@pytest.fixture(scope="module")
def facade(ckpts):
    det = apis.TwoStageDetector(
        "coarse_det", ckpts["coarse_det"], "mp_det_res50",
        ckpts["mp_det_res50"], coarse_options=COARSE_OPTS,
        mp_options=MP_OPTS, score_thr=1e-4, device="cpu")
    yield det
    det.close()


@pytest.fixture(scope="module")
def frames():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 256, (*FRAME, 3), np.uint8) for _ in range(6)]


def _same(got, want):
    """Detection dicts equal up to the order in which a batch of another
    composition ranks near-ties (module docstring)."""
    assert len(got["scores"]) == len(want["scores"])
    free = np.ones(len(want["scores"]), bool)
    for box, s, lab in zip(got["boxes"], got["scores"], got["labels"]):
        ok = (free & (want["labels"] == lab)
              & (np.abs(want["scores"] - s) <= 1e-6)
              & (np.abs(want["boxes"] - box).max(-1) <= 1e-4))
        assert ok.any(), f"no partner for {box} {s} {lab}"
        free[np.argmax(ok)] = False


def test_async_detector_equals_detect_batch(facade, frames):
    """Concurrent submits from several threads, dynamic batching and the
    two-deep streaming worker: every future resolves to what
    ``detect_batch`` gives for its frame."""
    want = facade.detect_batch([f.copy() for f in frames])
    assert sum(len(w["scores"]) for w in want) > 0
    for depth in (1, 2):
        adet = serve.AsyncDetector(facade, max_batch=4, batch_window_ms=20,
                                   pipeline_depth=depth)
        try:
            with ThreadPoolExecutor(4) as pool:
                futs = list(pool.map(lambda f: adet.submit(f.copy()),
                                     frames))
            got = [f.result(timeout=300) for f in futs]
        finally:
            adet.close()
        assert not adet._worker.is_alive()
        for g, w in zip(got, want):
            _same(g, w)
    adet = serve.AsyncDetector(facade, pipeline_depth=2)
    try:
        for g, w in zip(adet.map([f.copy() for f in frames[:2]]), want):
            _same(g, w)
    finally:
        adet.close()


def test_async_detector_surfaces_errors(facade):
    adet = serve.AsyncDetector(facade, pipeline_depth=2)
    try:
        fut = adet.submit(np.zeros((4, 4), np.uint8))      # no channels
        with pytest.raises(Exception):
            fut.result(timeout=300)
    finally:
        adet.close()


def _post(url, body, ctype="application/json"):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _raw_body(img):
    return json.dumps({"image": base64.b64encode(img.tobytes()).decode(),
                       "shape": list(img.shape), "dtype": "uint8"}).encode()


def _as_dets(items):
    return {"boxes": np.array([d["bbox"] for d in items],
                              np.float32).reshape(-1, 4),
            "scores": np.array([d["score"] for d in items], np.float32),
            "labels": np.array([d["class_label"] for d in items], np.int64)}


def test_http_service(facade, ckpts, frames):
    service = serve.DetectionService()
    adet = serve.AsyncDetector(facade, max_batch=4, pipeline_depth=2)
    service.register("two_stage", adet)
    det = apis.Detector("coarse_det", ckpts["coarse_det"], options=DET_OPTS,
                        device="cpu")
    service.register("coarse", det)
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert json.loads(_get(base + "/ping")[1]) == {"status": "Healthy"}
        assert json.loads(_get(base + "/models")[1]) == {
            "models": ["coarse", "two_stage"]}
        with ThreadPoolExecutor(4) as pool:
            answers = list(pool.map(
                lambda f: _post(base + "/predictions/two_stage",
                                _raw_body(f)), frames))
        want = facade.detect_batch([f.copy() for f in frames])
        for (code, body), w in zip(answers, want):
            assert code == 200
            items = json.loads(body)
            assert len(items) == len(w["scores"]) > 0
            for d in items:
                assert d["class_name"] == facade.class_names[
                    d["class_label"]]
            got = _as_dets(items)
            # the JSON rounds scores to 6 and boxes to 2 decimals
            np.testing.assert_allclose(np.sort(got["scores"]),
                                       np.sort(w["scores"]), atol=1e-6)
        # an encoded PNG (OpenCV decodes it), to the plain detector
        ok, png = cv2.imencode(".png", frames[0][..., ::-1])
        code, body = _post(base + "/predictions/coarse", png.tobytes(),
                           "image/png")
        assert code == 200
        got = _as_dets(json.loads(body))
        w = det.detect(frames[0])
        np.testing.assert_allclose(got["scores"], w["scores"], atol=1e-6)
        np.testing.assert_allclose(got["boxes"], w["boxes"], atol=0.006)
        # 404s and a 500
        assert _get(base + "/nope")[0] == 404
        assert _post(base + "/nope", b"{}")[0] == 404
        assert _post(base + "/predictions/absent", b"{}")[0] == 404
        code, body = _post(base + "/predictions/coarse", b"not an image")
        assert code == 500 and "error" in json.loads(body)
        code, body = _post(base + "/predictions/two_stage", json.dumps(
            {"image": base64.b64encode(b"\0" * 10).decode(),
             "shape": [4, 4, 3]}).encode())
        assert code == 500
        code, text = _get(base + "/metrics")
        text = text.decode()
        assert code == 200
        assert 'glsdet_requests_total{model="two_stage"} 6' in text
        assert 'glsdet_errors_total{model="two_stage"} 1' in text
        assert 'glsdet_requests_total{model="coarse"} 1' in text
        assert 'glsdet_errors_total{model="coarse"} 1' in text
        assert 'glsdet_request_latency_ms{model="two_stage",quantile="0.5"}' \
            in text
        assert 'glsdet_queue_depth{model="two_stage"} 0' in text
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        adet.close()
    assert not thread.is_alive()


def test_decode_image(monkeypatch):
    img = np.random.RandomState(1).randint(0, 256, (5, 7, 3), np.uint8)
    np.testing.assert_array_equal(serve._decode_image(_raw_body(img)), img)
    np.testing.assert_array_equal(serve._decode_image(_raw_body(img)),
                                  jserve._decode_image(_raw_body(img)))
    png = cv2.imencode(".png", img)[1].tobytes()
    wrapped = json.dumps({"image": base64.b64encode(png).decode()}).encode()
    for body in (png, wrapped):
        np.testing.assert_array_equal(serve._decode_image(body),
                                      jserve._decode_image(body))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match="OpenCV"):
        serve._decode_image(png)
    np.testing.assert_array_equal(serve._decode_image(_raw_body(img)), img)


def _manifest(path):
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read(serve.ARCHIVE_MANIFEST)), zf.namelist()


def test_archive_manifest_equals_the_jax_packages(tmp_path):
    kw = dict(model_name="m", class_names=["a", "b"], score_thr=0.2,
              mp_config="mp_det_res50", fuse_global=False, quant8="static",
              options={"model.phi": "nano"}, mp_options={"model.depth": 18})
    got = serve.archive_model("coarse_det", None, str(tmp_path / "t"), **kw)
    want = jserve.archive_model("coarse_det", None, str(tmp_path / "j"),
                                **kw)
    assert got.endswith(serve.ARCHIVE_SUFFIX)
    assert _manifest(got)[0] == _manifest(want)[0]
    with pytest.raises(FileExistsError):
        serve.archive_model("coarse_det", None, got)


def test_archive_round_trip(facade, ckpts, frames, tmp_path):
    """A two-stage archive with both checkpoints and saved int8 scales,
    and a single-model one: load_archive gives the files back, and
    register_archive serves what the facade built from them serves."""
    scales = str(tmp_path / "scales.json")
    with open(scales, "w") as f:
        f.write("{}")
    path = serve.archive_model(
        "coarse_det", ckpts["coarse_det"], str(tmp_path / "ts"),
        model_name="ts", score_thr=1e-4, mp_config="mp_det_res50",
        mp_checkpoint=ckpts["mp_det_res50"], options=COARSE_OPTS,
        mp_options=MP_OPTS)
    manifest, files = serve.load_archive(path, str(tmp_path / "unpacked"))
    assert manifest["pipeline"] == "two_stage"
    assert manifest["has_checkpoint"] and manifest["has_mp_checkpoint"]
    for key, name in (("coarse", "coarse_det"), ("mp", "mp_det_res50")):
        with open(files[key], "rb") as a, open(ckpts[name], "rb") as b:
            assert a.read() == b.read()
    service = serve.DetectionService()
    name = service.register_archive(path, async_batching=True,
                                    device="cpu")
    try:
        assert name == "ts"
        adet = service.models[name][0]
        assert isinstance(adet, serve.AsyncDetector)
        items = service.predict(name, _raw_body(frames[0]))
        want = facade.detect(frames[0])
        np.testing.assert_allclose(_as_dets(items)["scores"],
                                   want["scores"], atol=1e-6)
    finally:
        adet.close()
        adet._det.close()
    single = serve.archive_model(
        "coarse_det", ckpts["coarse_det"], str(tmp_path / "one"),
        score_thr=1e-4, options=DET_OPTS, quant8="static",
        int8_scales=scales)
    manifest, ckpt = serve.load_archive(single, str(tmp_path / "u1"))
    assert os.path.basename(ckpt) == serve.CKPT
    assert os.path.exists(manifest["_int8_scales_path"])
    names = _manifest(single)[1]
    assert sorted(names) == sorted([serve.ARCHIVE_MANIFEST, serve.CKPT,
                                    "int8_scales.json"])
