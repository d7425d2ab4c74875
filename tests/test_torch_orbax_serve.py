"""A JAX package archive served by the port, on the CPU.

A JAX ``serve.archive_model`` archive of a ``coarse_det`` (YOLOX-nano,
64x64, float32) orbax ``TrainState`` of seeded weights, opened by the
port's ``load_archive`` and served by its ``DetectionService``: the
answers match the JAX service's (same label, IoU > 0.99, scores within
1e-4, >= 95% both ways: tests/test_torch_two_stage.py's whole-run
standard).  The port's ``archive_model`` of the same orbax directory
embeds the converted weights, which load as the directory does.
"""

import base64
import json
import os

import jax
import numpy as np
import pytest
import torch

import glsdet_tpu.serve as jserve
import glsdet_tpu.train.loop as jloop
from glsdet_tpu.config import apply_overrides as j_overrides
from glsdet_tpu.config import get_config as j_get_config
from glsdet_tpu_torch import apis, serve
from glsdet_tpu_torch.utils.orbax_read import read_orbax
from test_torch_orbax import assert_same_tree
from test_torch_orbax_full import seeded_variables
from test_torch_two_stage import _matched

NANO = {"model.phi": "nano", "model.dtype": "float32",
        "data.img_hw": (64, 64), "eval.score_thr": 1e-3}


@pytest.fixture(scope="module")
def nano_ckpt(tmp_path_factory):
    """A JAX orbax TrainState of coarse_det at YOLOX-nano of seeded
    weights (at the initializers' constants every score ties at the
    prior)."""
    d = tmp_path_factory.mktemp("nano")
    cfg = j_overrides(j_get_config("coarse_det"), dict(NANO))
    v = seeded_variables(cfg, seed=4)
    state = jloop.make_state_template(cfg, v, jloop.build_optimizer(cfg, 10),
                                      jax.random.PRNGKey(0))
    return jloop.save_checkpoint(str(d), state, epoch=1)


def _body(img):
    return json.dumps({"image": base64.b64encode(img.tobytes()).decode(),
                       "shape": list(img.shape), "dtype": "uint8"}).encode()


def _dets(items):
    return {"boxes": np.array([d["bbox"] for d in items],
                              np.float32).reshape(-1, 4),
            "scores": np.array([d["score"] for d in items], np.float32),
            "labels": np.array([d["class_label"] for d in items], np.int64)}


def test_jax_archive_served_by_the_port(nano_ckpt, tmp_path):
    path = jserve.archive_model("coarse_det", nano_ckpt,
                                str(tmp_path / "jax"), model_name="m",
                                score_thr=1e-3, options=NANO)
    manifest, ckpt = serve.load_archive(path, str(tmp_path / "unpacked"))
    assert manifest["model_name"] == "m" and os.path.isdir(ckpt)
    assert_same_tree(read_orbax(ckpt), jloop.restore_raw(nano_ckpt))
    jservice, tservice = jserve.DetectionService(), serve.DetectionService()
    jservice.register_archive(path)
    tservice.register_archive(path, device="cpu")
    rs = np.random.RandomState(0)
    n = 0
    for _ in range(2):
        img = rs.randint(0, 256, (96, 160, 3), np.uint8)
        got = _dets(tservice.predict("m", _body(img)))
        want = _dets(jservice.predict("m", _body(img)))
        assert _matched(got, want) >= 0.95 and _matched(want, got) >= 0.95
        n += len(got["scores"])
    assert n > 0

    # the port's archive of the same directory: the converted weights
    ported = serve.archive_model("coarse_det", nano_ckpt,
                                 str(tmp_path / "port"), options=NANO)
    _, pt = serve.load_archive(ported, str(tmp_path / "u2"))
    assert os.path.basename(pt) == serve.CKPT
    a = apis.init_detector("coarse_det", pt, options=NANO, device="cpu")[2]
    b = apis.init_detector("coarse_det", nano_ckpt, options=NANO,
                           device="cpu")[2]
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_jax_two_stage_archive_builds_the_ports_detector(nano_ckpt,
                                                         tmp_path):
    """A two-stage JAX archive (orbax trees under ``ckpt/`` and
    ``ckpt_mp/``): ``load_archive`` gives both directories, and the
    ``TwoStageDetector`` that ``register_archive`` builds holds their
    weights (MP-Det depth 18)."""
    mp_opts = {"model.depth": 18, "model.dtype": "float32"}
    cfg = j_overrides(j_get_config("mp_det_res50"), dict(mp_opts))
    v = seeded_variables(cfg, seed=5)
    mp_ckpt = jloop.save_checkpoint(str(tmp_path / "mp"), {
        "params": v["params"], "batch_stats": v["batch_stats"]}, 1)
    opts = dict(NANO, **{"eval.mosaic_buckets": (128, 256)})
    path = jserve.archive_model("coarse_det", nano_ckpt,
                                str(tmp_path / "two"), model_name="two",
                                mp_config="mp_det_res50",
                                mp_checkpoint_dir=mp_ckpt, options=opts,
                                mp_options=mp_opts)
    manifest, dirs = serve.load_archive(path, str(tmp_path / "unpacked"))
    assert manifest["pipeline"] == "two_stage"
    assert_same_tree(read_orbax(dirs["mp"]), jloop.restore_raw(mp_ckpt))
    service = serve.DetectionService()
    service.register_archive(path, device="cpu")
    det = service.models["two"][0]
    try:
        want = apis.init_detector("mp_det_res50", mp_ckpt, options=mp_opts,
                                  device="cpu")[2]
        got = det.pipeline.mp.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
        out = det.detect(np.random.RandomState(1).randint(
            0, 256, (96, 160, 3), np.uint8))
        assert np.isfinite(out["scores"]).all()
    finally:
        det.close()
