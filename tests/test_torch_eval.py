"""Port parity: the eval slice's host evaluators and the rest of the
detection math against the JAX package, on seeded inputs.

- ``eval/coco_eval.py``, ``voc_map.py`` and ``ignore.py`` are the JAX
  package's numpy modules carried over: fed the same detections and GTs
  they must agree bit for bit (``np.array_equal`` on precision, recall,
  stats and per-class AP; equal ``summarize`` strings).  The cases cover
  crowd GTs, every area range, images without GTs or detections, more
  than 500 detections on an image, tied scores, other ``max_dets`` and
  area ranges, and ``eval_recalls``.
- Item 7's functions: the NMS family (``multiclass_nms``, ``diou_nms``,
  ``nms_match``) with equal keep masks, orders, groups and labels, boxes
  within 1e-5 and scores within 1e-6; ``level_priors`` equal;
  ``proxy_scores(return_sim=True)`` within 1e-5; the duplicate-per-chip
  ``unmap_chip_detections`` with equal masks and boxes within 1e-4
  (mosaic coordinates of ~1e3); the float preprocessing of
  ``ops/image.py`` within 2e-3 of 255 (XLA sums ``jax.image.resize``'s
  weight matrices in another order; the weights are bit-equal) and
  ``unletterbox_boxes`` within 1e-5; ``yolox_postprocess(single_label=
  False)``, ``gfl_postprocess(scores_are_logits=False)`` and
  ``rescale_detections`` at tests/test_torch_postprocess.py's tolerances.
- The NMS kernel's K limit (4096): beyond it the wrapper raises before
  any launch; a TTA union of 2400 rows runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.eval import coco_eval as jcoco
from glsdet_tpu.eval import ignore as jignore
from glsdet_tpu.eval import postprocess as jpp
from glsdet_tpu.eval import voc_map as jvoc
from glsdet_tpu.models import mp_head as jmp
from glsdet_tpu.models import yolox_head as jyh
from glsdet_tpu.ops import image as jimage
from glsdet_tpu.ops import nms as jnms
from glsdet_tpu.ufp import assembly as jasm
from glsdet_tpu_torch.eval import coco_eval as tcoco
from glsdet_tpu_torch.eval import ignore as tignore
from glsdet_tpu_torch.eval import postprocess as tpp
from glsdet_tpu_torch.eval import voc_map as tvoc
from glsdet_tpu_torch.models import mp_head as tmp
from glsdet_tpu_torch.models import yolox_head as tyh
from glsdet_tpu_torch.ops import image as timage
from glsdet_tpu_torch.ops import nms as tnms
from glsdet_tpu_torch.ops import nms_kernel
from glsdet_tpu_torch.ufp import assembly as tasm


# -- the carried-over evaluators ---------------------------------------------

def _boxes_xywh(rs, n, sizes=(2, 150)):
    """xywh boxes whose sides span the small, medium and large ranges."""
    xy = rs.uniform(0, 400, (n, 2))
    wh = np.exp(rs.uniform(np.log(sizes[0]), np.log(sizes[1]), (n, 2)))
    return np.concatenate([xy, wh], 1)


def _coco_case(name):
    """(gts, dets, num_classes, evaluator kwargs): detections are jittered
    copies of the GTs (hits at many IoUs) plus random boxes."""
    rs = np.random.RandomState(sum(map(ord, name)))
    k = 4
    gts, dets = {}, {}
    n_img = 6
    for img in range(n_img):
        ng = rs.randint(0, 25)
        if name == "empty_images" and img % 3 == 0:
            ng = 0
        g = _boxes_xywh(rs, ng)
        gl = rs.randint(0, k, ng)
        crowd = rs.rand(ng) < (0.15 if name == "crowd" else 0.0)
        gts[img] = (g, gl, crowd) if name == "crowd" else (g, gl)
        hit = rs.rand(ng) < 0.7
        jit = g[hit] + rs.normal(0, 1, (int(hit.sum()), 4)) * np.maximum(
            g[hit][:, 2:3] * 0.1, 0.5)
        jit[:, 2:] = np.abs(jit[:, 2:]) + 0.5
        n_fp = rs.randint(0, 30)
        if name == "over_500" and img == 1:
            n_fp = 620
        d = np.concatenate([jit, _boxes_xywh(rs, n_fp)])
        dl = np.concatenate([gl[hit], rs.randint(0, k, n_fp)])
        ds = rs.rand(len(d))
        if name == "ties":
            ds = np.round(ds * 4) / 4
        if name == "empty_images" and img % 3 == 1:
            d, ds, dl = np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64)
        if not (name == "empty_images" and img == 4):
            dets[img] = (d, ds, dl)
    kw = {}
    if name == "drone_ranges":
        kw = {"max_dets": (1, 10, 100),
              "area_rngs": {"all": (0.0, 1e10), "small": (0.0, 32 ** 2),
                            "medium": (32 ** 2, 1e10), "large": (1e10, 1e10)}}
    return gts, dets, k, kw


@pytest.mark.parametrize("name", ["random", "crowd", "empty_images",
                                  "over_500", "ties", "drone_ranges"])
def test_coco_evaluator_equals_jax(name):
    gts, dets, k, kw = _coco_case(name)
    got = tcoco.CocoEvaluator(k, **kw).evaluate(gts, dets)
    want = jcoco.CocoEvaluator(k, **kw).evaluate(gts, dets)
    assert np.array_equal(got.precision, want.precision)
    assert np.array_equal(got.recall, want.recall)
    assert np.array_equal(got.stats, want.stats)
    assert np.array_equal(got.per_class_ap, want.per_class_ap,
                          equal_nan=True)
    assert got.max_dets == want.max_dets
    assert (got.stats[:3] > 0).all()
    names = [f"c{i}" for i in range(k)]
    assert tcoco.summarize(got, names) == jcoco.summarize(want, names)
    assert tcoco.summarize(got) == jcoco.summarize(want)


def test_eval_recalls_and_constants_equal_jax():
    rs = np.random.RandomState(3)
    gts, props = {}, {}
    for img in range(5):
        g = _boxes_xywh(rs, rs.randint(0, 12))
        g[:, 2:] += g[:, :2]
        gts[img] = g
        p = np.concatenate([g + rs.normal(0, 3, g.shape),
                            _boxes_xywh(rs, 40)])
        p[len(g):, 2:] += p[len(g):, :2]
        props[img] = (p, rs.rand(len(p)))
    kw = dict(proposal_nums=(5, 20, 100), iou_thrs=(0.5, 0.7, 0.9))
    got = tcoco.eval_recalls(gts, props, **kw)
    assert np.array_equal(got, jcoco.eval_recalls(gts, props, **kw))
    assert got.max() > 0
    assert np.array_equal(tcoco.eval_recalls({0: np.zeros((0, 4))}, {}),
                          jcoco.eval_recalls({0: np.zeros((0, 4))}, {}))
    assert np.array_equal(tcoco.IOU_THRS, jcoco.IOU_THRS)
    assert np.array_equal(tcoco.REC_THRS, jcoco.REC_THRS)
    assert tcoco.AREA_RNGS == jcoco.AREA_RNGS


def test_voc_map_equals_jax():
    rs = np.random.RandomState(4)
    gts, dets = {}, {}
    for img in range(6):
        g = _boxes_xywh(rs, rs.randint(0, 15))
        g[:, 2:] += g[:, :2]
        gl = rs.randint(0, 5, len(g))
        gts[img] = (g, gl)
        d = np.concatenate([g + rs.normal(0, 2, g.shape),
                            _boxes_xywh(rs, rs.randint(0, 10))])
        d[len(g):, 2:] += d[len(g):, :2]
        dets[img] = (d, np.round(rs.rand(len(d)), 2),
                     np.concatenate([gl, rs.randint(0, 5, len(d) - len(g))]))
    for thr in (0.5, 0.75):
        got = tvoc.eval_voc_map(gts, dets, 6, iou_thr=thr)
        want = jvoc.eval_voc_map(gts, dets, 6, iou_thr=thr)
        assert got["map"] == want["map"] and got["map"] > 0
        assert got["per_class"].keys() == want["per_class"].keys()
        for c, v in got["per_class"].items():
            w = want["per_class"][c]
            assert v.keys() == w.keys()
            for key in v:
                assert np.array_equal(v[key], w[key], equal_nan=True), key
    rec = np.sort(rs.rand(30))
    prec = rs.rand(30)
    assert tvoc.voc_ap(rec, prec) == jvoc.voc_ap(rec, prec)
    for r, p in ((rec, prec), (np.zeros(0), np.zeros(0))):
        assert (tvoc.log_average_miss_rate(p, r, 7)
                == jvoc.log_average_miss_rate(p, r, 7))


def test_filter_ignore_regions_equals_jax():
    rs = np.random.RandomState(5)
    b = _boxes_xywh(rs, 50)
    b[:, 2:] += b[:, :2]
    s, lab = rs.rand(50), rs.randint(0, 3, 50)
    ig = np.array([[0, 0, 200, 200], [300, 100, 450, 300]], np.float32)
    for ignore in (ig, np.zeros((0, 4)), None):
        got = tignore.filter_ignore_regions(b, s, lab, ignore)
        want = jignore.filter_ignore_regions(b, s, lab, ignore)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert 0 < len(got[0]) <= 50


# -- item 7: the NMS family --------------------------------------------------

def _cluster_boxes(rs, k, extent=300.0):
    centres = rs.uniform(0, extent, (max(k // 6, 1), 2))
    c = centres[rs.randint(0, len(centres), k)] + rs.normal(0, 5, (k, 2))
    wh = rs.uniform(10, 50, (k, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)


@pytest.mark.parametrize("max_per_img", [20, 100])
def test_multiclass_nms_equals_jax(max_per_img):
    rs = np.random.RandomState(max_per_img)
    n, c = 300, 6
    boxes = _cluster_boxes(rs, n)
    scores = (rs.rand(n, c) ** 3).astype(np.float32)
    got = tnms.multiclass_nms(torch.from_numpy(boxes.copy()),
                              torch.from_numpy(scores.copy()), 0.05, 0.5,
                              max_per_img)
    want = jnms.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores),
                               0.05, 0.5, max_per_img)
    gb, gs, gl, gv = (t.numpy() for t in got)
    wb, ws, wl, wv = (np.asarray(t) for t in want)
    assert gb.shape == (max_per_img, 4) and gv.any()
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gb[gv], wb[wv], atol=1e-5)
    np.testing.assert_allclose(gs, ws, atol=1e-6)


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_diou_nms_equals_jax(thr):
    rs = np.random.RandomState(int(thr * 10))
    k = 200
    boxes = _cluster_boxes(rs, k)
    scores = rs.rand(k).astype(np.float32)
    scores[rs.rand(k) < 0.1] = jnms.NEG_INF
    keep, order = tnms.diou_nms(torch.from_numpy(boxes.copy()),
                                torch.from_numpy(scores.copy()), thr)
    jkeep, jorder = jnms.diou_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                  thr)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < int(keep.sum()) < k * 0.9


@pytest.mark.parametrize("thr", [0.3, 0.6])
def test_nms_match_equals_jax(thr):
    rs = np.random.RandomState(int(thr * 10) + 7)
    k = 150
    boxes = _cluster_boxes(rs, k)
    scores = rs.rand(k).astype(np.float32)
    scores[:5] = jnms.NEG_INF
    keep, group = tnms.nms_match(torch.from_numpy(boxes.copy()),
                                 torch.from_numpy(scores.copy()), thr)
    jkeep, jgroup = jnms.nms_match(jnp.asarray(boxes), jnp.asarray(scores),
                                   thr)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(group.numpy(), np.asarray(jgroup))
    assert group.dtype == torch.int32
    assert (group.numpy()[:5] == -1).all()
    assert (group.numpy() != np.arange(k)).sum() > 10


def test_nms_kernel_k_limit():
    """4096 rows is the kernel's limit; beyond it the wrapper raises
    before any launch (here on a CPU tensor, checked the same way); a
    TTA union of 2400 rows (tta_detect's defaults with 4 scales) runs."""
    with pytest.raises(ValueError, match="4096"):
        nms_kernel._check(torch.zeros(1, 4097, 4),
                          torch.ones(1, 4097, dtype=torch.bool))
    assert nms_kernel.MAX_K == 4096
    rs = np.random.RandomState(9)
    boxes = torch.from_numpy(_cluster_boxes(rs, 2400, 1500.0))[None]
    scores = torch.from_numpy(rs.rand(1, 2400).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 3, (1, 2400)))
    keep, _ = tnms.batched_nms(boxes, scores, labels, 0.65)
    assert keep.shape == (1, 2400) and 0 < int(keep.sum()) < 2400


# -- item 7: the smaller helpers ---------------------------------------------

def test_level_priors_equal_jax():
    sizes, strides = [(8, 12), (4, 6), (2, 3)], (8, 16, 32)
    for g, w in zip(tyh.level_priors(sizes, strides),
                    jyh.level_priors(sizes, strides)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_proxy_scores_return_sim_matches_jax():
    rs = np.random.RandomState(11)
    proxies_list = (2, 3, 1, 4)
    feat = rs.randn(50, 32).astype(np.float32)
    prox = rs.randn(sum(proxies_list), 32).astype(np.float32)
    mem = tmp.proxy_class_matrix(proxies_list)
    got = tmp.proxy_scores(torch.from_numpy(feat.copy()),
                           torch.from_numpy(prox.copy()),
                           torch.from_numpy(mem.copy()), return_sim=True)
    want = jmp.proxy_scores(jnp.asarray(feat), jnp.asarray(prox),
                            jnp.asarray(mem), return_sim=True)
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    plain = tmp.proxy_scores(torch.from_numpy(feat), torch.from_numpy(prox),
                             torch.from_numpy(mem))
    assert torch.equal(plain, got[0])


def test_unmap_chip_detections_matches_jax():
    rs = np.random.RandomState(12)
    regions = np.zeros((6, 7), np.float32)
    for i in range(5):
        w, h = rs.randint(20, 80, 2)
        f = [1, 2, 4][i % 3]
        regions[i] = [rs.randint(0, 600), rs.randint(0, 400), w, h,
                      (i % 3) * 330, (i // 3) * 330, f]
    chips = np.stack([regions[:, 4], regions[:, 5],
                      regions[:, 4] + regions[:, 2] * regions[:, 6],
                      regions[:, 5] + regions[:, 3] * regions[:, 6]], 1)
    pick = rs.randint(0, 5, 40)
    lo = chips[pick, :2] + rs.uniform(-5, 20, (40, 2))
    wh = rs.uniform(4, 60, (40, 2))
    det = np.concatenate([lo, lo + wh], 1).astype(np.float32)
    # one box covering two chips transfers through both
    det[0] = [0, 0, 700, 700]
    valid = rs.rand(40) > 0.2
    valid[0] = True
    got_b, got_v = tasm.unmap_chip_detections(
        torch.from_numpy(det.copy()), torch.from_numpy(valid.copy()),
        torch.from_numpy(regions.copy()))
    want_b, want_v = jasm.unmap_chip_detections(
        jnp.asarray(det), jnp.asarray(valid), jnp.asarray(regions))
    assert tuple(got_b.shape) == (40, 6, 4)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.numpy().sum() > 5
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-4)
    # batched: each image its own
    bb, bv = tasm.unmap_chip_detections(
        torch.from_numpy(np.stack([det, det[::-1].copy()])),
        torch.from_numpy(np.stack([valid, valid[::-1].copy()])),
        torch.from_numpy(np.stack([regions, regions])))
    assert torch.equal(bv[0], got_v) and torch.equal(bb[0], got_b)


# -- item 7: float preprocessing and postprocess arguments -------------------

@pytest.mark.parametrize("shape,out", [((96, 160, 3), (64, 64)),
                                       ((50, 40, 3), (128, 96))])
def test_float_preprocessing_matches_jax(shape, out):
    img = np.random.RandomState(13).randint(0, 256, shape, np.uint8)
    t = torch.from_numpy(img.copy())
    np.testing.assert_allclose(
        timage.normalize_image(t).numpy(),
        np.asarray(jimage.normalize_image(jnp.asarray(img))), atol=1e-6)
    assert timage.normalize_image(t, dtype=torch.bfloat16).dtype == \
        torch.bfloat16
    canvas, scale = timage.resize_keep_ratio(t, *out)
    jcanvas, jscale = jimage.resize_keep_ratio(jnp.asarray(img), *out)
    assert scale == jscale and canvas.dtype == torch.float32
    np.testing.assert_allclose(canvas.numpy(), np.asarray(jcanvas),
                               atol=2e-3)
    canvas, scale, pad = timage.letterbox(t, *out)
    jcanvas, jscale, jpad = jimage.letterbox(jnp.asarray(img), *out)
    assert scale == jscale and pad == jpad
    np.testing.assert_allclose(canvas.numpy(), np.asarray(jcanvas),
                               atol=2e-3)
    boxes = np.random.RandomState(14).uniform(0, 60, (20, 4)).astype(
        np.float32)
    np.testing.assert_allclose(
        timage.unletterbox_boxes(torch.from_numpy(boxes.copy()), scale,
                                 *pad).numpy(),
        np.asarray(jimage.unletterbox_boxes(jnp.asarray(boxes), scale,
                                            *jpad)), atol=1e-5)
    with pytest.raises(NotImplementedError):
        timage.letterbox(t, *out, method="lanczos3")


def _maps(rs, b, hw, strides, chans, loc=0.0):
    return [(loc + rs.randn(b, -(-hw[0] // s), -(-hw[1] // s), chans))
            .astype(np.float32) for s in strides]


def _compare(got, want):
    for key in ("valid", "labels"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    v = got["valid"].numpy()
    assert v.any()
    np.testing.assert_allclose(got["boxes"].numpy()[v],
                               np.asarray(want["boxes"])[v], atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-6)


def test_yolox_postprocess_multiclass_matches_jax():
    rs = np.random.RandomState(15)
    hw, strides, b = (64, 96), (8, 16, 32), 2
    maps = [_maps(rs, b, hw, strides, c, loc=loc)
            for c, loc in ((10, -1.0), (4, 0.0), (1, -1.0))]
    t = [[torch.from_numpy(m.copy()) for m in ms] for ms in maps]
    j = [[jnp.asarray(m.copy()) for m in ms] for ms in maps]
    got = tpp.yolox_postprocess(*t, hw, score_thr=0.05, max_dets=150,
                                single_label=False)
    want = jpp.yolox_postprocess(*j, hw, score_thr=0.05, max_dets=150,
                                 single_label=False)
    _compare(got, want)
    single = tpp.yolox_postprocess(*t, hw, score_thr=0.05, max_dets=150)
    # several classes of one anchor compete only without single_label
    assert int(got["valid"].sum()) > int(single["valid"].sum())


def test_gfl_postprocess_scores_not_logits_matches_jax():
    rs = np.random.RandomState(16)
    hw, strides, b = (128, 128), (8, 16, 32, 64, 128), 2
    cls = [(0.5 * rs.rand(*m.shape)).astype(np.float32)
           for m in _maps(rs, b, hw, strides, 10)]
    reg = _maps(rs, b, hw, strides, 68)
    got = tpp.gfl_postprocess([torch.from_numpy(m.copy()) for m in cls],
                              [torch.from_numpy(m.copy()) for m in reg], hw,
                              score_thr=0.05, max_dets=100, nms_pre=200,
                              scores_are_logits=False)
    want = jpp.gfl_postprocess([jnp.asarray(m) for m in cls],
                               [jnp.asarray(m) for m in reg], hw,
                               score_thr=0.05, max_dets=100, nms_pre=200,
                               scores_are_logits=False)
    _compare(got, want)
    assert float(got["scores"].max()) <= 0.5


def test_rescale_detections_matches_jax():
    rs = np.random.RandomState(17)
    dets = {"boxes": rs.uniform(0, 640, (2, 30, 4)).astype(np.float32),
            "scores": rs.rand(2, 30).astype(np.float32)}
    got = tpp.rescale_detections(
        {k: torch.from_numpy(v.copy()) for k, v in dets.items()},
        0.4703, (3.0, 120.0))
    want = jpp.rescale_detections(
        {k: jnp.asarray(v) for k, v in dets.items()}, 0.4703, (3.0, 120.0))
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=1e-6)
    assert torch.equal(got["scores"], torch.from_numpy(dets["scores"]))


def test_draw_detections_outlines_without_opencv(monkeypatch):
    """run_eval(show_dir=...) and Detector.detect_image draw with no
    OpenCV: each box above the threshold outlined in its class colour,
    the edges outside the image left out, the rest of the image as it
    was."""
    from glsdet_tpu_torch.utils import visualize

    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    img = np.random.RandomState(3).randint(0, 255, (40, 60, 3), np.uint8)
    boxes = np.array([[5, 6, 20, 30], [50, 30, 90, 70], [1, 1, 9, 9]],
                     np.float32)
    out = visualize.draw_detections(img, boxes, np.array([0.9, 0.5, 0.1]),
                                    np.array([1, 14, 0]), thickness=2)
    want = img.copy()
    ring = np.zeros(img.shape[:2], bool)
    ring[6:31, 5:21] = True
    ring[8:29, 7:19] = False
    want[ring] = visualize._PALETTE[1]
    want[30:32, 50:] = want[30:, 50:52] = visualize._PALETTE[14 % 12]
    np.testing.assert_array_equal(out, want)
    assert not np.array_equal(img, out) and out is not img
