"""The two-stage pipeline across several devices and in ``scan_width``
groups (``glsdet_tpu_torch/eval/two_stage.py``), and the serving facade
against the JAX facade on smooth frames, on the CPU.

Devices, as ``tests/test_two_stage.py: TestMultiDeviceServing`` checks the
JAX pipeline: ``devices=["cpu", "cpu"]`` (two handles to the one CPU;
``tests/test_torch_cuda.py`` runs two cards) serves each batch on the
next device in turn and gives exactly the one-device results; a device
outside the list raises; the facade's lazy static-int8 calibration runs
on the first device and serves the one-device facade's answers.

Groups, as ``TestScanWidth``: ``scan_width=2`` over chunks and stage-2
groups of 4 runs each stage in two groups and equals the flat run within
its tolerances (boxes rtol 1e-5 / atol 1e-4, scores 1e-5, labels equal:
the groups sum the convolutions of another batch size), with and without
the fusion; a chunk of 3 runs flat; ``scan_width=-2`` raises the JAX
``ValueError``.

The facade (ROADMAP.md, check C6): ``apis.TwoStageDetector.detect_batch``
against the JAX facade's pipeline (its ``_pipe_kwargs`` and ``_filter``,
float32, the Pallas painter in interpret mode), both on the same seeded
weights (``torch_tools_util.seeded_variables``), on smooth VisDrone-like
frames with flat boxes (``smooth_frame``).  The seeded full-width weights
serve boxes outside the frame and boxes of zero area on the card's
smooth frames; at test size the coarse regression predictors' weights
are scaled (``GAINS``) to make YOLOX's ``exp`` decode do the same.  Boxes
are paired by coordinates (a zero-area box has no IoU): same label,
score within 1e-4, corners within 1e-3 px + 1e-5 of their value; >= 95 %
paired both ways, as the noise-frame facade tests, the boxes outside the
frame on their own too, and the zero-area counts equal.

Port pipelines: seeded YOLOX-nano at 64x64 and MP-Det-18, buckets (128,
256), coarse threshold 1e-4, bucket-fit packing, one packing thread.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glsdet_tpu.eval.two_stage as jts
from glsdet_tpu.config import apply_overrides as japply
from glsdet_tpu.config import get_config as jget_config
from glsdet_tpu.train.loop import build_model as jbuild_model
from glsdet_tpu_torch import apis
from glsdet_tpu_torch.eval.two_stage import TwoStagePipeline
from glsdet_tpu_torch.models import MPDet, YOLOXDetector
from glsdet_tpu_torch.utils.flax_import import state_dict_from_flax
from torch_port_util import COARSE_OPTS, MP_OPTS, jax_two_stage_facade
from torch_tools_util import seeded_variables

FRAME = (96, 160)
KW = dict(coarse_score_thr=1e-4, mosaic_buckets=(128, 256), max_batch=4,
          pack_mode="bucket-fit", pack_threads=1, device="cpu")


def pipeline(**more):
    g = torch.Generator().manual_seed(0)
    kw = {**KW, **more}
    return TwoStagePipeline(YOLOXDetector(10, "nano", generator=g),
                            MPDet(10, 18, generator=g), (64, 64), **kw)


def noise_frames(n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (*FRAME, 3), np.uint8) for _ in range(n)]


def smooth_frame(seed, hw):
    """A smooth field (a coarse random grid resized up) with 5-20 flat
    boxes of 4-24 px and +-2 codes of noise: the smoke's VisDrone-like
    frames at test size."""
    rs = np.random.RandomState(seed)
    h, w = hw
    coarse = rs.randint(40, 216, (h // 32 + 2, w // 32 + 2, 3), np.uint8)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR)
    img = img.astype(np.int16)
    for _ in range(rs.randint(5, 21)):
        bw, bh = rs.randint(4, 25), rs.randint(4, 25)
        x, y = rs.randint(0, w - bw), rs.randint(0, h - bh)
        img[y:y + bh, x:x + bw] = rs.randint(0, 256, 3)
    img += rs.randint(-2, 3, img.shape).astype(np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def same(a, b):
    for key in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(a[key], b[key])


@pytest.fixture(scope="module")
def flat():
    pipe = pipeline()
    yield pipe
    pipe.close()


def test_round_robin_matches_single_device(flat):
    multi = pipeline(devices=["cpu", torch.device("cpu")])
    turns = []
    step = multi._next_device
    multi._next_device = lambda: turns.append(step()) or turns[-1]
    batches = [noise_frames(1, 7 + k) for k in range(3)]
    try:
        handles = [multi.submit_batch(b) for b in batches]
        outs = [multi.collect_batch(h) for h in handles]
    finally:
        multi.close()
    assert turns == [torch.device("cpu")] * 3      # one turn per batch
    assert len(multi._replicas) == 1               # one copy per device
    for got, imgs in zip(outs, batches):
        want = flat.run_batch(imgs)
        assert sum(len(w["boxes"]) for w in want) > 0
        for a, b in zip(got, want):
            same(a, b)
    with pytest.raises(ValueError, match="not one of the pipeline"):
        multi.submit_device_batch(torch.zeros((1, *FRAME, 3),
                                              dtype=torch.uint8,
                                              device="meta"))


def test_static_int8_facade_calibrates_once_for_every_device():
    """The facade's lazy calibration on the first batch's frames runs on
    the first device; every device then serves from those scales, the
    one-device facade's answers."""
    frames = noise_frames(1, 3)
    kw = dict(coarse_options={**COARSE_OPTS,
                              "eval.mosaic_buckets": (128,)},
              mp_options=MP_OPTS, quant8="static", max_batch=1)
    one = apis.TwoStageDetector("coarse_det", device="cpu", **kw)
    two = apis.TwoStageDetector("coarse_det", devices=["cpu", "cpu"], **kw)
    try:
        want = one.detect_batch(frames)
        got = two.detect_batch(frames)
        assert two.pipeline.quant8 == "static"
        assert two.pipeline.devices == [torch.device("cpu")] * 2
    finally:
        one.close()
        two.close()
    for a, b in zip(got, want):
        same(a, b)


def assert_close(ref, got):
    """``TestScanWidth._assert_same``."""
    assert len(ref) == len(got)
    assert sum(len(r["boxes"]) for r in ref) > 0
    for a, b in zip(ref, got):
        assert len(a["boxes"]) == len(b["boxes"])
        np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(a["labels"], b["labels"])


@pytest.mark.parametrize("fuse_global", [False, True])
def test_scan_width_groups_match_flat(flat, fuse_global):
    ref = flat if not fuse_global else pipeline(fuse_global=True)
    scan = pipeline(scan_width=2, fuse_global=fuse_global)
    widths = {"coarse": [], "stage2": []}
    coarse, stage2 = scan._coarse_group, scan._stage2_group
    scan._coarse_group = lambda net, imgs: (
        widths["coarse"].append(len(imgs)) or coarse(net, imgs))
    scan._stage2_group = lambda rep, imgs, idx, *a: (
        widths["stage2"].append(len(idx)) or stage2(rep, imgs, idx, *a))
    frames = noise_frames(4, 11 + fuse_global)
    try:
        want = ref.run_batch(frames)
        h = scan.submit_batch(frames)
        scan.dispatch_mosaics(h)
        n_groups = len({id(out) for _, out, _ in h.pending})
        got = scan.collect_batch(h)
        assert widths["coarse"] == [2, 2]
        # each stage-2 bucket group of 4 ran as two; one of width 1 or 3
        # as it is
        assert all(w <= 2 or w == 3 for w in widths["stage2"])
        assert len(widths["stage2"]) >= n_groups
        widths["coarse"].clear()
        scan.run_batch(frames[:3])
        assert widths["coarse"] == [3]             # 3 % 2: flat
    finally:
        scan.close()
        if ref is not flat:
            ref.close()
    assert_close(want, got)


def test_bad_scan_width_raises():
    with pytest.raises(ValueError, match="scan_width"):
        TwoStagePipeline(torch.nn.Identity(), torch.nn.Identity(), (64, 64),
                         scan_width=-2, device="cpu")


def paired(a, b):
    """Share of a's detections with a partner in b: same label, score
    within 1e-4, every corner within 1e-3 px + 1e-5 of its value (the
    scaled regressions below put corners past 1e8 px)."""
    if not len(a["boxes"]):
        return 1.0
    hits = 0
    for box, s, lab in zip(a["boxes"], a["scores"], a["labels"]):
        cand = (b["labels"] == lab) & (np.abs(b["scores"] - s) < 1e-4)
        near = np.abs(b["boxes"][cand] - box) <= 1e-3 + 1e-5 * np.abs(box)
        hits += int(near.all(axis=1).any())
    return hits / len(a["boxes"])


def outside(d, hw):
    """The detections that do not overlap the frame."""
    h, w = hw
    b = d["boxes"]
    off = ~((b[:, 0] < w) & (b[:, 2] > 0) & (b[:, 1] < h) & (b[:, 3] > 0))
    return {k: v[off] for k, v in d.items()}


def zero_area(d):
    b = d["boxes"]
    return int(((b[:, 2] <= b[:, 0]) | (b[:, 3] <= b[:, 1])).sum())


@pytest.fixture(scope="module")
def facades():
    """Seeded weights of both configs, the JAX facade (for its pipeline
    arguments and filter) and its pipeline in float32 with the Pallas
    painter, the JAX facade's own on its TPU (the XLA painter it picks on
    the CPU paints these clipped mosaics otherwise: 30 % of the boxes
    pair)."""
    variables = {}
    for name, opts in (("coarse_det", COARSE_OPTS), ("mp_det_res50",
                                                     MP_OPTS)):
        cfg = japply(jget_config(name), dict(opts))
        variables[name] = seeded_variables(jbuild_model(cfg),
                                           tuple(cfg.data.img_hw), 0)
    jdet = jax_two_stage_facade(jax.device_put(variables))
    jpipe = jts.TwoStagePipeline(*jdet._applies, mosaic_dtype=jnp.float32,
                                 painter="pallas", pack_threads=1,
                                 **{**jdet._pipe_kwargs, **C6_LADDER})
    return variables, jdet, jpipe


# one bucket: every mosaic of these frames is clipped to it
C6_LADDER = {"mosaic_buckets": (128,)}


# the coarse regression predictors' weights scaled per level: seeded
# weights at test size serve boxes inside the frame; scaled, YOLOX's
# exp(reg) decode serves boxes outside it (and, at the largest gains,
# of zero area, exp underflowing), as the seeded full-width weights do
# on the card's smooth frames
GAINS = {"some_outside": (1.0, 8.0, 96.0), "zero_area": (128.0,) * 3}


@pytest.mark.parametrize("case", sorted(GAINS))
def test_facade_serves_the_jax_facades_boxes_outside_the_frame(
        facades, tmp_path, case):
    """ROADMAP check C6 (module docstring)."""
    variables, jdet, jpipe = facades
    coarse = jax.tree_util.tree_map(np.array, variables["coarse_det"])
    head = coarse["params"]["head"]
    for level, gain in enumerate(GAINS[case]):
        head[f"reg_pred{level}"] = {
            k: v * np.float32(gain)
            for k, v in head[f"reg_pred{level}"].items()}
    paths = []
    for name, v in (("coarse_det", coarse),
                    ("mp_det_res50", variables["mp_det_res50"])):
        paths.append(str(tmp_path / f"{name}.pt"))
        torch.save(state_dict_from_flax(v), paths[-1])
    hw = (120, 200)
    frames = [smooth_frame(seed, hw) for seed in range(2)]
    jpipe._cvars = jax.device_put(coarse)      # same shapes: no recompile
    want = [jdet._filter(o) for o in jpipe.run_batch(
        [f.copy() for f in frames])]
    tdet = apis.TwoStageDetector(
        "coarse_det", paths[0], "mp_det_res50", paths[1],
        coarse_options={**COARSE_OPTS,
                        "eval.mosaic_buckets": C6_LADDER["mosaic_buckets"]},
        mp_options=MP_OPTS, device="cpu")
    try:
        got = tdet.detect_batch([f.copy() for f in frames])
    finally:
        tdet.close()
    n_in = n_out = n_zero = 0
    for g, w in zip(got, want):
        assert paired(g, w) >= 0.95 and paired(w, g) >= 0.95
        go, wo = outside(g, hw), outside(w, hw)
        assert paired(go, wo) >= 0.95 and paired(wo, go) >= 0.95
        assert zero_area(g) == zero_area(w)
        n_in += len(g["boxes"]) - len(go["boxes"])
        n_out += len(go["boxes"])
        n_zero += zero_area(go)
    assert n_out > 0, (n_in, n_out, n_zero)
    if case == "some_outside":
        assert n_in > n_out
    else:
        assert n_zero > 0
