"""Port parity: the serving facades (``glsdet_tpu_torch/apis.py``) against
the JAX package's ``apis.py``, on the CPU.

Test size: YOLOX-nano (``coarse_det`` with ``model.phi=nano``, input
64x64) and MP-Det depth 18 (``mp_det_res50`` with ``model.depth=18``),
buckets (128, 256), RandomState(0) noise frames of 96x160, coarse
threshold 1e-4.  The coarse weights are a flax init with jittered
constant leaves (``torch_port_util.flax_vars``), carried across by
``state_dict_from_flax`` into the state-dict file that the port's facades
load; MP-Det's are the port's seeded initialisation.  The two-stage
facade is held against the JAX facade's own pipeline run in
tests/test_torch_two_stage_global.py, which compiles that pipeline once
for both files; here it must equal the port's pipeline built from the JAX
facade's ``_pipe_kwargs`` and filtered by the JAX facade's ``_filter``.

Tolerances are tests/test_torch_two_stage.py's: on shared inputs valid
and labels equal, boxes within 1e-4, scores within 1e-6; whole runs
matched detection by detection, >= 95% both ways.  The port's resize
must equal ``cv2.resize`` value for value.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glsdet_tpu.apis as japis
from glsdet_tpu.config import apply_overrides as japply
from glsdet_tpu.config import get_config as jget_config
from glsdet_tpu.data.coco import normalize as jnormalize
from glsdet_tpu.train.loop import build_model as jbuild_model
from glsdet_tpu_torch import apis
from glsdet_tpu_torch.config import apply_overrides, get_config
from glsdet_tpu_torch.eval.two_stage import TwoStagePipeline, pack_detections
from glsdet_tpu_torch.models import GFLDet, YOLOXDetector
from glsdet_tpu_torch.models.variants import FFAYoloBody
from glsdet_tpu_torch.models.build import build_model
from glsdet_tpu_torch.ops.image import resize_linear_u8
from glsdet_tpu_torch.utils.flax_import import state_dict_from_flax
from test_torch_two_stage import FRAME, _agree, _matched
from torch_port_util import (COARSE_OPTS, MP_OPTS, flax_vars,
                             jax_two_stage_facade, pipe_kwargs)

DET_OPTS = {"model.phi": "nano", "model.dtype": "float32",
            "data.img_hw": (64, 64), "eval.score_thr": 1e-4}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Config name -> (flax variables or None, state-dict file): the
    coarse model's flax variables and the same weights as a file; MP-Det's
    seeded port initialisation as a file."""
    d = tmp_path_factory.mktemp("weights")
    cfg = japply(jget_config("coarse_det"), dict(COARSE_OPTS))
    v = flax_vars(jbuild_model(cfg), np.zeros((1, 64, 64, 3), np.float32))
    out = {"coarse_det": (v, str(d / "coarse_det.pt")),
           "mp_det_res50": (None, str(d / "mp_det_res50.pt"))}
    torch.save(state_dict_from_flax(v), out["coarse_det"][1])
    mp = build_model(apply_overrides(get_config("mp_det_res50"),
                                     dict(MP_OPTS)),
                     device="cpu", generator=torch.Generator().manual_seed(0))
    torch.save(mp.state_dict(), out["mp_det_res50"][1])
    return out


@pytest.fixture(scope="module")
def frames():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 256, (*FRAME, 3), np.uint8) for _ in range(3)]


@pytest.fixture(scope="module")
def two_stage(weights):
    """The JAX facade at the test configs (its pipeline arguments and
    filter; no weights) and the port's facade on the weights' files."""
    jdet = jax_two_stage_facade()
    tdet = apis.TwoStageDetector(
        "coarse_det", weights["coarse_det"][1], "mp_det_res50",
        weights["mp_det_res50"][1], coarse_options=COARSE_OPTS,
        mp_options=MP_OPTS, device="cpu")
    yield jdet, tdet
    tdet.close()


def test_two_stage_facades_build_the_same_pipeline(two_stage):
    jdet, tdet = two_stage
    got = {k: v for k, v in tdet._pipe_kwargs.items() if k != "device"}
    assert got == pipe_kwargs(jdet)
    assert got["fuse_global"] and got["pack_mode"] == "square"
    pipe = tdet.pipeline
    assert (pipe.fuse_global, pipe.pack_mode, pipe.max_batch) == (
        True, "square", 8)
    assert tdet.score_thr == jdet.score_thr == 0.01
    assert tdet.class_names == jdet.class_names


def test_two_stage_detect_batch_matches(two_stage, weights, frames):
    """The port's facade equals the port's pipeline built from the JAX
    facade's ``_pipe_kwargs`` on the same weights, filtered by the JAX
    facade's own ``_filter`` (the JAX facade's run itself is held in
    test_torch_two_stage_global.py)."""
    jdet, tdet = two_stage
    models = [apis.init_detector(name, weights[name][1], options=opts,
                                 device="cpu")[1]
              for name, opts in (("coarse_det", COARSE_OPTS),
                                 ("mp_det_res50", MP_OPTS))]
    pipe = TwoStagePipeline(*models, device="cpu", **pipe_kwargs(jdet))
    try:
        want = [jdet._filter(o) for o in pipe.run_batch(
            [f.copy() for f in frames])]
    finally:
        pipe.close()
    got = tdet.detect_batch([f.copy() for f in frames])
    assert len(got) == len(frames)
    for g, w in zip(got, want):
        assert len(g["boxes"]) > 0
        assert (g["scores"] >= tdet.score_thr).all()
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(g[key], w[key])
    # the streaming protocol gives what detect_batch gives
    h = tdet.submit_batch([f.copy() for f in frames])
    tdet.advance_batch(h)
    for g, w in zip(tdet.collect_batch(h), got):
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(g[key], w[key])


@pytest.fixture(scope="module")
def detectors(weights):
    """The JAX ``Detector`` built with ``__new__`` (as tests/test_apis.py
    does) and the port's, on the same weights."""
    jd = japis.Detector.__new__(japis.Detector)
    cfg = japply(jget_config("coarse_det"), dict(DET_OPTS))
    model = jbuild_model(cfg)
    jd.cfg = cfg
    jd.class_names = list(apis.VISDRONE_CLASSES)
    jd.score_thr = cfg.eval.score_thr
    jd._raw_apply = model.apply
    jd._variables = jax.device_put(weights["coarse_det"][0])
    jd._set_fwd(model.apply)
    td = apis.Detector("coarse_det", weights["coarse_det"][1],
                       options=DET_OPTS, device="cpu")
    return jd, td


def test_detector_inputs_and_outputs_agree(detectors, frames):
    """Shared inputs: the port's model input equals the JAX facade's
    (``normalize(cv2.resize(...))``) exactly, and the decoded detections
    of the same input agree at the stated tolerances."""
    jd, td = detectors
    want_in = np.stack([jnormalize(cv2.resize(f, (64, 64))) for f in frames])
    got_in = td._inputs(frames)
    np.testing.assert_array_equal(got_in.permute(0, 2, 3, 1).numpy(),
                                  want_in)
    w = jd._fwd(jd._variables, jnp.asarray(want_in))
    want = pack_detections(*(torch.from_numpy(np.array(w[k]))
                             for k in ("boxes", "scores", "labels", "valid")))
    assert _agree(td._fwd(got_in), want.numpy()) > 10


def test_detector_detect_batch_matches(detectors, frames):
    jd, td = detectors
    rs = np.random.RandomState(5)
    imgs = [f.copy() for f in frames] + [
        rs.randint(0, 256, (120, 90, 3), np.uint8)]
    want = jd.detect_batch([im.copy() for im in imgs])
    got = td.detect_batch([im.copy() for im in imgs])
    for g, w in zip(got, want):
        assert len(g["boxes"]) > 0
        assert _matched(g, w) >= 0.95 and _matched(w, g) >= 0.95
    # alone, as a batch of one (the CPU convolutions sum a batch of 1 in
    # another order than a batch of 4)
    one = td.detect(imgs[-1])
    assert _matched(one, got[-1]) == 1.0 and _matched(got[-1], one) == 1.0


@pytest.mark.parametrize("src,dst", [((96, 160), (64, 64)),
                                     ((765, 1360), (640, 640)),
                                     ((300, 500), (640, 640)),
                                     ((128, 128), (64, 64)),
                                     ((50, 70), (64, 96))])
def test_resize_equals_cv2(src, dst):
    img = np.random.RandomState(sum(src)).randint(0, 256, (*src, 3),
                                                  np.uint8)
    got = resize_linear_u8(torch.from_numpy(img.copy()), dst).numpy()
    np.testing.assert_array_equal(got, cv2.resize(img, dst[::-1]))


def test_static_int8_lazy_calibration_is_saved_and_loaded(weights, frames,
                                                          tmp_path):
    """quant8="static" without scales: the first batch calibrates (on its
    first 4 frames; one frame here) and writes the scales file; a second
    facade loads it and gives the same detections."""
    path = str(tmp_path / "scales.json")
    # one bucket, 128: the int8 convolutions' CPU route is slow
    kw = dict(coarse_options={**COARSE_OPTS, "eval.mosaic_buckets": (128,)},
              mp_options=MP_OPTS,
              quant8="static", int8_scales=path, device="cpu")
    args = ("coarse_det", weights["coarse_det"][1], "mp_det_res50",
            weights["mp_det_res50"][1])
    first = apis.TwoStageDetector(*args, **kw)
    try:
        assert first._needs_calibration and not os.path.exists(path)
        got = first.detect_batch([frames[0].copy()])
        assert os.path.exists(path) and not first._needs_calibration
        assert first.pipeline.quant8 == "static"
    finally:
        first.close()
    second = apis.TwoStageDetector(*args, **kw)
    try:
        assert not second._needs_calibration
        assert second.pipeline.quant8 == "static"
        again = second.detect_batch([frames[0].copy()])
    finally:
        second.close()
    assert sum(len(g["boxes"]) for g in got) > 0
    for g, w in zip(again, got):
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(g[key], w[key])


def test_detector_static_int8_lazy_calibration(weights, frames, tmp_path):
    path = str(tmp_path / "det_scales.json")
    kw = dict(options=DET_OPTS, quant8="static", int8_scales=path,
              device="cpu")
    first = apis.Detector("coarse_det", weights["coarse_det"][1], **kw)
    assert first._needs_calibration and not os.path.exists(path)
    got = first.detect_batch([f.copy() for f in frames])
    assert os.path.exists(path) and not first._needs_calibration
    second = apis.Detector("coarse_det", weights["coarse_det"][1], **kw)
    assert not second._needs_calibration
    for g, w in zip(second.detect_batch([f.copy() for f in frames]), got):
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(g[key], w[key])


def test_map_txt_round_trip(detectors, frames, tmp_path):
    """get_map_txt writes what detect returns; the port's and the JAX
    package's load_det_txt read it back alike."""
    _, td = detectors
    path = td.get_map_txt("0001", frames[0], str(tmp_path))
    d = td.detect(frames[0])
    boxes, scores, labels = apis.load_det_txt(path, td.class_names)
    for got, want in zip((boxes, scores, labels),
                         japis.load_det_txt(path, td.class_names)):
        np.testing.assert_array_equal(got, want)
    assert len(scores) == len(d["scores"]) > 0
    np.testing.assert_array_equal(labels, d["labels"])
    np.testing.assert_array_equal(boxes, d["boxes"].astype(int))
    np.testing.assert_allclose(scores, d["scores"], atol=5e-7)


def test_init_detector_checkpoint_and_errors(weights, tmp_path):
    cfg, model, state = apis.init_detector(
        "coarse_det", weights["coarse_det"][1], options=DET_OPTS,
        device="cpu")
    assert cfg.model.phi == "nano" and not model.training
    want = torch.load(weights["coarse_det"][1])
    assert set(state) == set(want)
    for k in want:
        torch.testing.assert_close(state[k], want[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not hold the weights"):
        apis.init_detector("mp_det_res50", weights["coarse_det"][1],
                           options=MP_OPTS, device="cpu")
    with pytest.raises(KeyError, match="unknown config"):
        apis.init_detector("nope", device="cpu")


# the ids (and the name) are those of the test when these families still
# raised, so that a run's results line up with earlier runs'
@pytest.mark.parametrize("family", ["gfl", "ffa"],
                         ids=["gfl-item 5", "ffa-item 13"])
def test_build_model_families_still_to_port_raise(family):
    """Every family of the JAX package builds: gfl a GFLDet, ffa an
    FFAYoloBody, and coarse_det with ``variant="lsk"`` a YOLOXDetector
    with its LSK blocks; without a card the default device raises."""
    cfg = get_config("yolox_ffa" if family == "ffa" else "coarse_det")
    cfg.model.family, cfg.model.phi = family, "nano"
    if family == "gfl":
        cfg.model.depth, cfg.model.feat_channels = 18, 64
        assert type(build_model(cfg, device="cpu")) is GFLDet
    else:
        assert type(build_model(cfg, device="cpu")) is FFAYoloBody
    variant = get_config("coarse_det")
    variant.model.phi, variant.model.variant = "nano", "lsk"
    model = build_model(variant, device="cpu")
    assert type(model) is YOLOXDetector and hasattr(model, "lsk2")
    if not torch.cuda.is_available():
        for c in (cfg, variant):
            with pytest.raises(RuntimeError, match="no GPU"):
                build_model(c)


def test_devices_and_cuda_without_a_card_raise():
    """``devices=`` builds a facade serving on each device in turn (two
    handles to the CPU here; tests/test_torch_replicas.py holds its
    answers); on ``cuda`` devices without a card it raises, as the
    default device does."""
    det = apis.TwoStageDetector("coarse_det", coarse_options=COARSE_OPTS,
                                mp_options=MP_OPTS, devices=["cpu", "cpu"])
    try:
        assert det.pipeline.devices == [torch.device("cpu")] * 2
        assert det._pipe_kwargs["devices"] == ["cpu", "cpu"]
    finally:
        det.close()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: build_model(get_config("coarse_det")),
                 lambda: apis.Detector("coarse_det", options=DET_OPTS),
                 lambda: apis.TwoStageDetector(
                     "coarse_det", coarse_options=COARSE_OPTS,
                     mp_options=MP_OPTS),
                 lambda: apis.TwoStageDetector(
                     "coarse_det", coarse_options=COARSE_OPTS,
                     mp_options=MP_OPTS, devices=["cuda:0", "cuda:1"])):
        with pytest.raises(RuntimeError, match="no GPU"):
            make()
