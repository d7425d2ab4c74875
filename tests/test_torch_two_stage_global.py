"""Port parity: two-stage serving with global-local fusion and the square
packing mode (the JAX package's ``TwoStagePipeline(fuse_global=True)``
with its default ``pack_mode="square"``), on the CPU.

The models of tests/test_torch_two_stage.py: YOLOX-nano and MPDet depth
18 with the same flax weights (the coarse ones jittered), coarse input
64x64, buckets (128, 256), three RandomState(0) noise frames of 96x160,
coarse threshold 1e-4.  The JAX pipeline is the JAX ``TwoStageDetector``'s
own: built from the facade's ``_pipe_kwargs`` (fusion on, square packing,
``max_batch`` 8) with its weights, painting with the Pallas kernel in
interpret mode; both sides run float32 with one packing thread.  The
port's ``TwoStageDetector`` is held against the same pipeline's run.
Square packing lays these frames' regions out at about 580x736, which
both pipelines clip to the 256 bucket.

Tolerances are tests/test_torch_two_stage.py's: on the same inputs valid
and labels equal, boxes within 1e-4, scores within 1e-6 (5e-6 where
MP-Det's logits feed them); whole ``run_batch`` outputs matched
detection by detection, >= 95% both ways.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glsdet_tpu.eval.two_stage as jts
import glsdet_tpu_torch.eval.two_stage as tts
from glsdet_tpu import native as jnative
from glsdet_tpu.models import MPDet as JMPDet
from glsdet_tpu.models import YOLOXDetector as JYOLOX
from glsdet_tpu_torch import apis
from glsdet_tpu_torch.models import MPDet, YOLOXDetector
from glsdet_tpu_torch.utils.flax_import import state_dict_from_flax
from test_torch_two_stage import BUCKETS, COARSE_HW, FRAME, _agree, _matched
from torch_port_util import (COARSE_OPTS, MP_OPTS, flax_vars,
                             jax_two_stage_facade, load_flax, pipe_kwargs)


@pytest.fixture(scope="module")
def weights():
    x = np.zeros((1, 64, 64, 3), np.float32)
    return {"coarse_det": flax_vars(JYOLOX(num_classes=10, phi="nano"), x),
            "mp_det_res50": flax_vars(JMPDet(num_classes=10, depth=18), x,
                                      perturb=False)}


@pytest.fixture(scope="module")
def setup(weights):
    """(JAX pipeline, port pipeline, port pipeline factory, frames, JAX
    facade).  The JAX pipeline is the JAX facade's; the port's takes the
    same arguments except ``pack_mode``, whose default must be the
    facade's (square)."""
    jdet = jax_two_stage_facade(jax.device_put(weights))
    jpipe = jts.TwoStagePipeline(*jdet._applies, mosaic_dtype=jnp.float32,
                                 painter="pallas", pack_threads=1,
                                 **jdet._pipe_kwargs)
    kw = pipe_kwargs(jdet)
    assert kw.pop("pack_mode") == "square" and kw["fuse_global"]
    assert kw["coarse_hw"] == COARSE_HW and kw["mosaic_buckets"] == BUCKETS
    del kw["fuse_global"]

    def tpipe(**more):
        g = torch.Generator().manual_seed(0)
        return tts.TwoStagePipeline(
            load_flax(YOLOXDetector(10, "nano", generator=g),
                      weights["coarse_det"]),
            load_flax(MPDet(10, 18, generator=g), weights["mp_det_res50"]),
            pack_threads=1, device="cpu", **kw, **more)

    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 256, (*FRAME, 3), np.uint8) for _ in range(3)]
    pipe = tpipe(fuse_global=True)
    yield jpipe, pipe, tpipe, frames, jdet
    pipe.close()


def test_defaults_agree():
    """pack_mode "square", bucket_policy "image", fusion off at 0.65, on
    both sides."""
    j = inspect.signature(jts.TwoStagePipeline).parameters
    t = inspect.signature(tts.TwoStagePipeline).parameters
    for name, want in (("pack_mode", "square"), ("bucket_policy", "image"),
                       ("fuse_global", False), ("fusion_nms_thr", 0.65)):
        assert j[name].default == t[name].default == want


@pytest.mark.parametrize("kw", [{"pack_mode": "fit"},
                                {"bucket_policy": "max"}])
def test_bad_packing_options_raise_alike(kw):
    with pytest.raises(ValueError) as want:
        jts.TwoStagePipeline(lambda im: im, lambda im: im, COARSE_HW, **kw)
    with pytest.raises(ValueError) as got:
        tts.TwoStagePipeline(torch.nn.Identity(), torch.nn.Identity(),
                             COARSE_HW, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def _sets(rs, b, k, n_valid):
    boxes = rs.uniform(0, 150, (b, k, 2))
    boxes = np.concatenate([boxes, boxes + rs.uniform(5, 40, (b, k, 2))],
                           -1).astype(np.float32)
    labels = rs.randint(0, 10, (b, k))
    # near-duplicates of the same class, for NMS to suppress
    boxes[:, 1::4] = boxes[:, 0::4][:, :boxes[:, 1::4].shape[1]] + 1.0
    labels[:, 1::4] = labels[:, 0::4][:, :labels[:, 1::4].shape[1]]
    scores = rs.uniform(0.01, 1, (b, k)).astype(np.float32)
    scores[:, 2::5] = scores[:, :1]                    # ties
    valid = np.arange(k)[None] < n_valid[:, None]
    return boxes, scores, labels, valid


def test_fuse_packed_equal():
    """The fusion step alone on shared inputs: coarse sets (b, 200, 7) and
    unmapped sets (b, 500), one frame's coarse set empty."""
    rs = np.random.RandomState(1)
    gb, gs, gl, gv = _sets(rs, 3, 200, np.array([150, 0, 200]))
    gdets = np.concatenate([gb, gs[..., None], gl[..., None],
                            gv[..., None]], -1).astype(np.float32)
    lb, ls, ll, lv = _sets(rs, 3, 500, np.array([300, 500, 0]))
    want = jax.vmap(lambda *a: jts._fuse_packed(*a, iou_thr=0.65,
                                                max_out=500))(
        jnp.asarray(gdets), jnp.asarray(lb), jnp.asarray(ls),
        jnp.asarray(ll.astype(np.int32)), jnp.asarray(lv))
    got = tts._fuse_packed(torch.from_numpy(gdets), torch.from_numpy(lb),
                           torch.from_numpy(ls), torch.from_numpy(ll),
                           torch.from_numpy(lv), iou_thr=0.65, max_out=500)
    n = _agree(tts.pack_detections(*got), jts.pack_detections(*want))
    assert 500 < n < int(gv.sum() + lv.sum())        # some suppressed


def _square_group(jpipe, frames):
    """The JAX pipeline's coarse detections of the three frames, their
    square-packed rows and the bucket, padded to a batch of 4 as the JAX
    pipeline pads a group."""
    stack = np.stack(frames + frames[-1:])
    coarse = np.asarray(jpipe._coarse_full_batch(jnp.asarray(stack.copy())))
    sx, sy = FRAME[1] / COARSE_HW[1], FRAME[0] / COARSE_HW[0]
    rows, buckets = [], set()
    for i in range(len(stack)):
        boxes = (coarse[i, :, :4] * np.array([sx, sy, sx, sy], np.float32))[
            coarse[i, :, 6] > 0.5]
        r, n_reg, mw, mh = jnative.unified_foreground_packing_rows(
            boxes, 1.5, (FRAME[1], FRAME[0]), 32)
        assert n_reg > 0
        rows.append(r)
        buckets.add(jts.pick_bucket(mh, mw, BUCKETS))
    assert len(buckets) == 1
    return stack, coarse, np.stack(rows), buckets.pop()


def test_fused_stage2_agrees_on_the_same_inputs(setup):
    jpipe, tpipe, _, frames, _ = setup
    stack, coarse, regs, bucket = _square_group(jpipe, frames)
    idx = np.arange(len(stack), dtype=np.int32)
    sx, sy = FRAME[1] / COARSE_HW[1], FRAME[0] / COARSE_HW[0]
    g = jts._scale_packed(coarse[idx], sx, sy)
    np.testing.assert_array_equal(tts._scale_packed(coarse[idx], sx, sy), g)
    want = jpipe._mosaic_stage_batch_fused(
        jnp.asarray(stack.copy()), jnp.asarray(idx), jnp.asarray(regs.copy()),
        jnp.asarray(regs.copy()), jnp.asarray(g.copy()), bucket)
    got = tpipe.stage2_packed(torch.from_numpy(stack.copy()),
                              torch.from_numpy(idx.astype(np.int64)),
                              torch.from_numpy(regs.copy()), bucket,
                              torch.from_numpy(g.copy()))
    # stage-2 scores at 5e-6, as tests/test_torch_two_stage.py
    assert _agree(got, want, score_atol=5e-6) > 0


@pytest.fixture(scope="module")
def fused_run(setup):
    """The port's fused run_batch of the three frames, through the
    streaming protocol: (handle, results)."""
    _, tpipe, _, frames, _ = setup
    h = tpipe.submit_batch([f.copy() for f in frames])
    tpipe.dispatch_mosaics(h)
    return h, tpipe.collect_batch(h)


@pytest.fixture(scope="module")
def jax_run(setup):
    """The JAX facade's pipeline on the three frames (run_batch)."""
    jpipe, _, _, frames, _ = setup
    return jpipe.run_batch([f.copy() for f in frames])


def test_run_batch_matches_with_fusion(setup, fused_run, jax_run):
    jpipe, tpipe, _, frames, _ = setup
    assert tpipe.pack_mode == jpipe.pack_mode == "square"
    want = jax_run
    h, got = fused_run
    assert len(h.pending) == len(frames) and not h.fallbacks
    for g, w in zip(got, want):
        assert len(g["boxes"]) > 0
        assert _matched(g, w) >= 0.95 and _matched(w, g) >= 0.95


def test_two_stage_facade_matches_the_jax_facade(setup, weights, jax_run,
                                                tmp_path):
    """The port's TwoStageDetector, loading the same weights from
    state-dict files, against the JAX facade's pipeline run filtered by
    the JAX facade's own ``_filter``."""
    _, _, _, frames, jdet = setup
    paths = []
    for name in ("coarse_det", "mp_det_res50"):
        paths.append(str(tmp_path / f"{name}.pt"))
        torch.save(state_dict_from_flax(weights[name]), paths[-1])
    tdet = apis.TwoStageDetector("coarse_det", paths[0], "mp_det_res50",
                                 paths[1], coarse_options=COARSE_OPTS,
                                 mp_options=MP_OPTS, device="cpu")
    try:
        assert pipe_kwargs(jdet) == {k: v for k, v in
                                     tdet._pipe_kwargs.items()
                                     if k != "device"}
        got = tdet.detect_batch([f.copy() for f in frames])
    finally:
        tdet.close()
    assert tdet.score_thr == jdet.score_thr
    for g, w in zip(got, (jdet._filter(o) for o in jax_run)):
        assert len(g["boxes"]) > 0
        assert (g["scores"] >= tdet.score_thr).all()
        assert _matched(g, w) >= 0.95 and _matched(w, g) >= 0.95


def _no_regions(monkeypatch, module, which):
    """Make ``module``'s square packer find no region for the frames
    whose packing call number is in ``which`` (frames pack in order with
    one packing thread)."""
    calls = []
    real = module.unified_foreground_packing_rows

    def pack(boxes, scale, input_shape, max_regions, *a, **kw):
        calls.append(len(calls))
        if calls[-1] in which:
            return np.zeros((max_regions, 7), np.float32), 0, 0.0, 0.0
        return real(boxes, scale, input_shape, max_regions, *a, **kw)

    monkeypatch.setattr(module, "unified_foreground_packing_rows", pack)


def test_frames_without_regions_take_their_coarse_sets(setup, monkeypatch):
    """Every frame packs to nothing: both pipelines return each frame's
    coarse set in frame coordinates, and run no stage 2."""
    jpipe, tpipe, _, frames, _ = setup
    _no_regions(monkeypatch, jts, {0, 1, 2})
    _no_regions(monkeypatch, tts, {0, 1, 2})
    want = jpipe.run_batch([f.copy() for f in frames])
    h = tpipe.submit_batch([f.copy() for f in frames])
    tpipe.dispatch_mosaics(h)
    assert not h.pending and len(h.fallbacks) == len(frames)
    got = tpipe.collect_batch(h)
    coarse = tpipe.coarse_packed(torch.from_numpy(np.stack(frames))).numpy()
    sx, sy = FRAME[1] / COARSE_HW[1], FRAME[0] / COARSE_HW[0]
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g["boxes"]) > 0
        pack = lambda d: np.concatenate([  # noqa: E731
            d["boxes"], d["scores"][:, None], d["labels"][:, None],
            np.ones((len(d["scores"]), 1))], -1)[None]
        assert _agree(pack(g), pack(w)) == len(g["boxes"])
        mine = tts._coarse_row_dets(coarse[i], sx, sy)
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(g[key], mine[key])


def test_a_frame_without_regions_among_others(setup, fused_run,
                                              monkeypatch):
    """Frame 1 packs to nothing: it takes its coarse set, the others match
    what they give without the patch (their stage-2 group is one mosaic
    smaller, and the CPU convolutions sum a batch of 2 in another order
    than a batch of 3).  Without fusion, frames without regions are
    empty."""
    _, tpipe, make, frames, _ = setup
    base = fused_run[1]
    _no_regions(monkeypatch, tts, {1, 4})
    got = tpipe.run_batch([f.copy() for f in frames])
    coarse = tpipe.coarse_packed(torch.from_numpy(np.stack(frames))).numpy()
    sx, sy = FRAME[1] / COARSE_HW[1], FRAME[0] / COARSE_HW[0]
    mine = tts._coarse_row_dets(coarse[1], sx, sy)
    for key in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(got[1][key], mine[key])
    for i in (0, 2):
        assert _matched(got[i], base[i]) >= 0.95
        assert _matched(base[i], got[i]) >= 0.95
    _no_regions(monkeypatch, tts, {0, 1, 2})
    plain = make()                     # fuse_global=False
    try:
        h = plain.submit_batch([f.copy() for f in frames])
        out = plain.collect_batch(h)
    finally:
        plain.close()
    assert not h.pending and not h.fallbacks
    assert all(len(o["boxes"]) == 0 for o in out)


def test_chunk_max_runs_a_chunk_as_one_group():
    """A chunk whose frames need two buckets (bucket-fit packing of a small
    and a large region set): "image" gives two stage-2 groups,
    "chunk-max" one at the larger bucket, as the JAX package's collapse."""
    dets = {"boxes": np.zeros((2, 4, 4), np.float32),
            "valid": np.zeros((2, 4), bool)}
    dets["boxes"][0, 0] = [10, 10, 20, 20]
    dets["boxes"][1] = [[0, 0, 60, 60], [70, 0, 130, 60], [0, 70, 60, 130],
                        [70, 70, 130, 130]]
    dets["valid"][0, 0] = True
    dets["valid"][1] = True
    jobs = {}
    for policy in ("image", "chunk-max"):
        pipe = tts.TwoStagePipeline(
            torch.nn.Identity(), torch.nn.Identity(), (160, 160),
            mosaic_buckets=(128, 256, 512), pack_mode="bucket-fit",
            bucket_policy=policy, pack_threads=1, device="cpu")
        jobs[policy] = pipe._pack_chunk([(160, 160)] * 2, [0, 1], dets)
        pipe.close()
    assert len(jobs["image"]) == 2
    want = jts._collapse_jobs_to_max_bucket(jobs["image"])
    assert list(jobs["chunk-max"]) == list(want) == [max(jobs["image"])]
    for (i, row, rows), (wi, wrow, wrows) in zip(
            jobs["chunk-max"][max(want)], want[max(want)]):
        assert (i, row) == (wi, wrow)
        np.testing.assert_array_equal(rows, wrows)
