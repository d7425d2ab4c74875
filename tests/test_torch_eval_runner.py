"""Port parity: the eval entry points against the JAX package's, on the
CPU, with the same flax weights and PNG frames written by the port's
``write_png``.

- ``tta_detect`` on a deterministic numpy detector: equal outputs (the
  scaled frames are bit-equal to ``cv2.resize``, the union NMS keeps the
  same rows), at 2 scales and at the 2400-row union of 4 scales x flip x
  300.
- ``run_eval`` (YOLOX-nano at 64x64, batch 2 over 5 frames, so the tail
  batch repeats a frame; MP-Det depth 18 at 128x128, ``max_dets`` 100)
  and ``run_eval_tta`` (scales 1.0 and 1.25, flip): the per-image
  detections match one for one (same label, IoU > 0.99, scores within
  1e-4) and the 12 COCO stats agree within 1e-3 (TTA: 1e-2, near-tied
  scores of an anchor's variants rank either way).  The ground truth is
  the JAX model's own detections, jittered by up to 2 pixels and with
  every third dropped, under category ids 1, 3, ..., 19, so that AP is
  well above 0 and a wrong unletterbox, clip or category mapping moves it.
- ``glsdet_tpu_torch.tools.ufpmp_det_eval.main`` against the JAX tool's
  ``main`` (``tools/ufpmp_det_eval.py``), both with ``--fuse-global`` and
  the facades' test configs (YOLOX-nano at 64x64, MP-Det depth 18,
  buckets 128/256, coarse threshold 1e-4, float32), the JAX pipeline in
  float32 with the Pallas painter in interpret mode, its checkpoints the
  same flax variables: at least 95% of the detections matched both ways
  (UFP packing floors coordinates, so a 1e-6 difference in the coarse
  stage can move a chip by a pixel, tests/test_torch_two_stage.py), the
  COCO stats within 0.02.
- Guards: ``mesh=`` takes ``parallel.data_mesh()`` (a process alone
  gives the detections of no mesh; two processes are
  ``test_torch_dist_loop.py``'s) and raises ``TypeError`` for anything
  else, an orbax checkpoint directory raises naming item 8;
  ``out_json`` maps labels to the dataset's category ids, ``format_only``
  returns no result, ``show_dir`` writes one PNG per frame.
"""

import importlib.util
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.data.coco import CocoDataset as JDataset
from glsdet_tpu.eval import runner as jrunner
from glsdet_tpu.eval.tta import tta_detect as jtta
from glsdet_tpu.models import MPDet as JMPDet
from glsdet_tpu.models import YOLOXDetector as JYOLOX
from glsdet_tpu_torch.data.coco import CocoDataset as TDataset
from glsdet_tpu_torch.data.image_io import read_image, write_png
from glsdet_tpu_torch.eval import runner as trunner
from glsdet_tpu_torch.eval.tta import tta_detect as ttta
from glsdet_tpu_torch.models import MPDet, YOLOXDetector
from glsdet_tpu_torch.ops.boxes import pairwise_iou
from glsdet_tpu_torch.parallel import data_mesh
from glsdet_tpu_torch.tools import ufpmp_det_eval as ttool
from glsdet_tpu_torch.utils.flax_import import state_dict_from_flax
from torch_port_util import (COARSE_OPTS, MP_OPTS, flax_vars, load_flax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = ((96, 160), (80, 120), (64, 64), (100, 75), (90, 150))
CAT_IDS = [2 * i + 1 for i in range(10)]


def _write_set(root, gts=None, name="ann.json", frames=FRAMES):
    """``frames`` (smooth fields with flat rectangles) as PNGs and a COCO
    json; ``gts`` maps file index -> list of (xywh, contiguous label)."""
    img_root = os.path.join(root, "img")
    os.makedirs(img_root, exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(frames):
        path = os.path.join(img_root, f"{i}.png")
        if not os.path.exists(path):
            rs = np.random.RandomState(i)
            img = np.kron(rs.randint(40, 216, (h // 8 + 1, w // 8 + 1, 3)),
                          np.ones((8, 8, 1)))[:h, :w]
            for _ in range(6):
                bh, bw = rs.randint(6, 30, 2)
                y, x = rs.randint(0, h - bh), rs.randint(0, w - bw)
                img[y:y + bh, x:x + bw] = rs.randint(0, 256, 3)
            write_png(path, img.astype(np.uint8))
        images.append({"id": 100 + i, "file_name": f"{i}.png", "width": w,
                       "height": h})
        for box, lab in (gts or {}).get(i, []):
            anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                         "category_id": CAT_IDS[lab],
                         "bbox": [float(v) for v in box], "iscrowd": 0})
    ann = os.path.join(root, name)
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": f"c{c}"}
                                  for c in CAT_IDS]}, f)
    return ann, img_root


def _gts_from(dets_by_img, seed):
    """Ground truth from detections: every third dropped, the rest
    jittered by up to 2 pixels."""
    rs = np.random.RandomState(seed)
    gts = {}
    for img_id, (xywh, _, labels) in dets_by_img.items():
        keep = [j for j in range(len(xywh)) if j % 3 != 2][:40]
        gts[img_id - 100] = [
            (np.maximum(xywh[j] + rs.uniform(-2, 2, 4), [0, 0, 1, 1]),
             int(labels[j])) for j in keep]
    return gts


class Recorder:
    """Stands in for a runner module's CocoEvaluator and records what it
    scored."""

    def __init__(self, evaluator_cls):
        self.cls, self.calls = evaluator_cls, []

    def __call__(self, *a, **kw):
        ev = self.cls(*a, **kw)
        real = ev.evaluate

        def evaluate(gts, dets):
            res = real(gts, dets)
            self.calls.append((gts, dets, res))
            return res

        ev.evaluate = evaluate
        return ev


def _run(module, monkeypatch, fn, *args, **kw):
    rec = Recorder(module.CocoEvaluator)
    monkeypatch.setattr(module, "CocoEvaluator", rec)
    res, stats = fn(*args, **kw)
    assert len(rec.calls) == 1
    return res, stats, rec.calls[0][1]


def _match(got, want, iou=0.99, score_tol=1e-4):
    """Detections of each image paired one to one: same label, IoU above
    ``iou`` (or, for boxes of no area, coordinates within 1e-3), scores
    within ``score_tol``.  Returns (pairs, |got|, |want|)."""
    pairs = n_got = n_want = 0
    assert sorted(got) == sorted(want)
    for img_id in want:
        gb, gs, gl = got[img_id]
        wb, ws, wl = want[img_id]
        n_got, n_want = n_got + len(gb), n_want + len(wb)
        if not len(gb) or not len(wb):
            continue

        def xyxy(b):
            b = np.asarray(b, np.float32)
            return torch.from_numpy(np.concatenate([b[:, :2], b[:, :2]
                                                    + b[:, 2:]], 1))

        ious = pairwise_iou(xyxy(gb), xyxy(wb)).numpy()
        # boxes clipped to nothing (anchors over the letterbox padding)
        # have no IoU: they pair by their coordinates
        same = np.abs(np.asarray(gb, np.float32)[:, None]
                      - np.asarray(wb, np.float32)[None]).max(-1) <= 1e-3
        same_label = np.asarray(gl)[:, None] == np.asarray(wl)[None, :]
        close = (np.abs(np.asarray(gs)[:, None] - np.asarray(ws)[None, :])
                 <= score_tol)
        ok = ((ious > iou) | same) & same_label & close
        used = np.zeros(len(wb), bool)
        for i in range(len(gb)):
            cand = np.nonzero(ok[i] & ~used)[0]
            if len(cand):
                used[cand[np.argmax(ious[i, cand])]] = True
                pairs += 1
    return pairs, n_got, n_want


# -- tta_detect ---------------------------------------------------------------

def _fake_detector(n):
    """A deterministic numpy detector: ``n`` boxes placed by a seed taken
    from the frame's pixels, weighted by column so that scaled and flipped
    frames differ (and no two variants tie in score: the JAX package
    ranks the union with numpy's unstable default sort)."""
    def detect(img):
        h, w = img.shape[:2]
        seed = int((img[..., 0].astype(np.int64) * np.arange(w)).sum())
        rs = np.random.RandomState(seed % 2 ** 31)
        xy = rs.uniform(0, 1, (n, 2)) * [w * 0.8, h * 0.8]
        wh = rs.uniform(0.05, 0.2, (n, 2)) * [w, h]
        return {"boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
                "scores": rs.rand(n).astype(np.float32),
                "labels": rs.randint(0, 4, n)}
    return detect


@pytest.mark.parametrize("scales,max_dets,n", [((1.0, 1.25), 50, 40),
                                               ((0.5, 0.75, 1.0, 1.5),
                                                300, 300)])
def test_tta_detect_equals_jax(scales, max_dets, n):
    img = np.random.RandomState(1).randint(0, 256, (90, 150, 3), np.uint8)
    got = ttta(_fake_detector(n), img, scales=scales, max_dets=max_dets,
               device="cpu")
    want = jtta(_fake_detector(n), img, scales=scales, max_dets=max_dets)
    for key in ("boxes", "scores", "labels"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert 0 < len(got["boxes"]) <= max_dets


# -- run_eval / run_eval_tta --------------------------------------------------

@pytest.fixture(scope="module")
def yolox():
    jm = JYOLOX(num_classes=10, phi="nano")
    v = flax_vars(jm, np.zeros((1, 64, 64, 3), np.float32))
    tm = load_flax(YOLOXDetector(10, "nano",
                                 generator=torch.Generator().manual_seed(0)),
                   v)
    japply = jax.jit(lambda vv, x: jm.apply(vv, x, train=False))
    return japply, jax.device_put(v), tm


@pytest.fixture(scope="module")
def yolox_set(tmp_path_factory, yolox):
    """The frames with the JAX YOLOX's own jittered detections as GTs."""
    japply, v, _ = yolox
    root = str(tmp_path_factory.mktemp("yolox_set"))
    ann, img_root = _write_set(root, name="bare.json")
    calls = []
    rec = Recorder(jrunner.CocoEvaluator)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunner, "CocoEvaluator", rec)
        jrunner.run_eval(JDataset(ann, img_root), japply, "yolox", (64, 64),
                         10, variables=v, **YOLOX_KW)
        calls = rec.calls
    ann, img_root = _write_set(root, _gts_from(calls[0][1], 0))
    return ann, img_root


YOLOX_KW = dict(batch_size=2, score_thr=1e-3, max_dets=100, verbose=False)


def test_run_eval_yolox_matches_jax(yolox, yolox_set, monkeypatch):
    japply, v, tm = yolox
    ann, img_root = yolox_set
    want, wstats, wdets = _run(jrunner, monkeypatch, jrunner.run_eval,
                               JDataset(ann, img_root), japply, "yolox",
                               (64, 64), 10, variables=v, **YOLOX_KW)
    got, gstats, gdets = _run(trunner, monkeypatch, trunner.run_eval,
                              TDataset(ann, img_root), tm, "yolox",
                              (64, 64), 10, device="cpu", **YOLOX_KW)
    pairs, n_got, n_want = _match(gdets, wdets)
    assert pairs == n_got == n_want and n_want > 50
    assert gstats["images"] == wstats["images"] == len(FRAMES)
    assert 0.0 <= gstats["host_share"] <= 1.0
    np.testing.assert_allclose(got.stats, want.stats, atol=1e-3)
    assert want.ap > 0.3 and want.ap50 > 0.5


def test_run_eval_tta_matches_jax(yolox, yolox_set, monkeypatch):
    japply, v, tm = yolox
    ann, img_root = yolox_set
    kw = dict(tta_scales=(1.0, 1.25), tta_flip=True, score_thr=1e-3,
              max_dets=100, verbose=False, max_images=3)
    want, wstats, wdets = _run(jrunner, monkeypatch, jrunner.run_eval_tta,
                               JDataset(ann, img_root), japply, "yolox",
                               (64, 64), 10, variables=v, **kw)
    got, gstats, gdets = _run(trunner, monkeypatch, trunner.run_eval_tta,
                              TDataset(ann, img_root), tm, "yolox",
                              (64, 64), 10, device="cpu", **kw)
    pairs, n_got, n_want = _match(gdets, wdets)
    assert pairs == n_got == n_want and n_want > 30
    assert gstats["images"] == wstats["images"] == 3
    assert gstats["tta_scales"] == [1.0, 1.25] and gstats["tta_flip"]
    # the union holds four variants of each anchor, whose seeded scores
    # lie within ~1e-7 of each other: the two rankings can order such a
    # near-tie differently, and COCO's greedy matching then pairs a GT
    # with the other copy
    np.testing.assert_allclose(got.stats, want.stats, atol=1e-2)
    assert want.ap > 0.1


def test_run_eval_mpdet_matches_jax(tmp_path, monkeypatch):
    jm = JMPDet(num_classes=10, depth=18, feat_channels=64)
    v = flax_vars(jm, np.zeros((1, 128, 128, 3), np.float32))
    tm = load_flax(MPDet(10, 18, 64,
                         generator=torch.Generator().manual_seed(0)), v)
    japply = jax.jit(lambda vv, x: jm.apply(vv, x, train=False))
    v = jax.device_put(v)
    kw = dict(batch_size=2, score_thr=0.05, max_dets=100, verbose=False,
              max_images=3)
    ann, img_root = _write_set(str(tmp_path), name="bare.json")
    _, _, seed_dets = _run(jrunner, monkeypatch, jrunner.run_eval,
                           JDataset(ann, img_root), japply, "gfl",
                           (128, 128), 10, variables=v, **kw)
    ann, img_root = _write_set(str(tmp_path), _gts_from(seed_dets, 1))
    want, _, wdets = _run(jrunner, monkeypatch, jrunner.run_eval,
                          JDataset(ann, img_root), japply, "gfl",
                          (128, 128), 10, variables=v, **kw)
    # the functional call of the port's train eval_fn: weights as
    # ``variables``, the input dtype given
    sd = dict(tm.state_dict())
    got, gstats, gdets = _run(
        trunner, monkeypatch, trunner.run_eval, TDataset(ann, img_root),
        lambda w, x: torch.func.functional_call(tm, w, (x,)), "gfl",
        (128, 128), 10, variables=sd, dtype=torch.float32, device="cpu",
        **kw)
    pairs, n_got, n_want = _match(gdets, wdets)
    assert pairs == n_got == n_want and n_want > 50
    # max_images stops after the batch that reaches it
    assert gstats["images"] == 4
    np.testing.assert_allclose(got.stats, want.stats, atol=1e-3)
    assert want.ap > 0.1


def test_run_eval_outputs_and_guards(yolox, yolox_set, tmp_path):
    _, _, tm = yolox
    ann, img_root = yolox_set
    ds = TDataset(ann, img_root)
    with pytest.raises(TypeError, match="data_mesh"):
        trunner.run_eval(ds, tm, "yolox", (64, 64), 10, mesh=object(),
                         device="cpu")
    # a process alone is a mesh of one: the same detections as no mesh
    # (two processes: tests/test_torch_dist_loop.py)
    one = str(tmp_path / "one.json")
    trunner.run_eval(ds, tm, "yolox", (64, 64), 10, out_json=one,
                     format_only=True, mesh=data_mesh("cpu"), **YOLOX_KW)
    out = str(tmp_path / "dets.json")
    show = str(tmp_path / "show")
    res, stats = trunner.run_eval(ds, tm, "yolox", (64, 64), 10,
                                  out_json=out, format_only=True,
                                  show_dir=show, device="cpu", **YOLOX_KW)
    assert res is None and stats["images"] == len(FRAMES)
    with open(out) as f:
        dump = json.load(f)
    with open(one) as f:
        assert json.load(f) == dump
    assert dump and {d["category_id"] for d in dump} <= set(CAT_IDS)
    assert {d["image_id"] for d in dump} == {100 + i
                                              for i in range(len(FRAMES))}
    for i, hw in enumerate(FRAMES):
        assert read_image(os.path.join(show, f"{i}.png")).shape == (*hw, 3)
    if not torch.cuda.is_available():
        # the default device is the card, and nothing falls back
        with pytest.raises(RuntimeError, match="no GPU"):
            trunner.run_eval(ds, tm, "yolox", (64, 64), 10)


# -- the two-stage entry ------------------------------------------------------

def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_ufpmp_det_eval", os.path.join(ROOT, "tools", "ufpmp_det_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _opts(opts):
    return [f"{k}={v!r}" if not isinstance(v, str) else f"{k}={v}"
            for k, v in opts.items()]


def test_ufpmp_det_eval_matches_jax_tool(tmp_path, monkeypatch):
    import glsdet_tpu.eval.two_stage as jts
    import glsdet_tpu.train.loop as jloop

    jc, jm = JYOLOX(num_classes=10, phi="nano"), JMPDet(num_classes=10,
                                                        depth=18)
    x = np.zeros((1, 64, 64, 3), np.float32)
    variables = {"coarse": flax_vars(jc, x),
                 "mp": flax_vars(jm, x, perturb=False)}
    paths = {}
    for key, v in variables.items():
        paths[key] = str(tmp_path / f"{key}.pt")
        torch.save(state_dict_from_flax(v), paths[key])
    by_path = {paths[k]: v for k, v in variables.items()}
    # one frame shape: one chunk, so the JAX pipeline compiles each
    # program once
    frames = (FRAMES[0],) * 4
    ann, img_root = _write_set(str(tmp_path), frames=frames)
    args = [None, None, None, None, ann, img_root, "--fuse-global",
            "--first-options", *_opts(COARSE_OPTS),
            "--second-options", *_opts(MP_OPTS)]

    # the JAX tool as it runs, its checkpoints the same variables (the
    # training-state template it restores them into is skipped: it only
    # carries them) and its pipeline in float32 with the Pallas painter
    # (interpret mode)
    def restore(path, state):
        v = by_path[path]
        return types.SimpleNamespace(ema_params=v["params"],
                                     batch_stats=v["batch_stats"])

    real_pipe = jts.TwoStagePipeline

    def pipe(*a, **kw):
        return real_pipe(*a, mosaic_dtype=jnp.float32, painter="pallas",
                         pack_threads=1, **kw)

    monkeypatch.setattr(jloop, "make_state_template", lambda *a: None)
    monkeypatch.setattr(jloop, "restore_checkpoint", restore)
    monkeypatch.setattr(jts, "TwoStagePipeline", pipe)
    jout = str(tmp_path / "jax.json")
    argv = ["coarse_det", paths["coarse"], "mp_det_res50", paths["mp"],
            *args[4:], "--out-json", jout]
    monkeypatch.setattr(sys, "argv", ["ufpmp_det_eval.py", *argv])
    _jax_tool().main()
    monkeypatch.undo()

    tout = str(tmp_path / "port.json")
    got, stats = ttool.main([*argv[:-1], tout, "--device", "cpu"])
    assert stats["images"] == len(frames)

    def by_img(path):
        with open(path) as f:
            dump = json.load(f)
        out = {100 + i: ([], [], []) for i in range(len(frames))}
        for d in dump:
            b, s, lab = out[d["image_id"]]
            b.append(d["bbox"])
            s.append(d["score"])
            lab.append(CAT_IDS.index(d["category_id"]))
        return {k: (np.asarray(b, np.float32).reshape(-1, 4),
                    np.asarray(s, np.float32), np.asarray(lab))
                for k, (b, s, lab) in out.items()}

    gdets, wdets = by_img(tout), by_img(jout)
    pairs, n_got, n_want = _match(gdets, wdets, iou=0.9, score_tol=1e-3)
    assert n_want > 50
    assert pairs >= 0.95 * n_want and pairs >= 0.95 * n_got, (
        pairs, n_got, n_want)
    # the set has no annotations: the tool scores nothing (-1, COCO's
    # "no ground truth"); both dumps are then scored against the JAX
    # tool's own detections, jittered and thinned
    assert (got.stats == -1).all()
    gts = {k: (np.stack([b for b, _ in rows]) if rows else
               np.zeros((0, 4)), np.asarray([lab for _, lab in rows]))
           for k, rows in ((100 + i, r) for i, r in
                           _gts_from(wdets, 2).items())}
    from glsdet_tpu_torch.eval.coco_eval import CocoEvaluator

    got = CocoEvaluator(10).evaluate(gts, gdets)
    want = CocoEvaluator(10).evaluate(gts, wdets)
    assert want.ap > 0.3
    np.testing.assert_allclose(got.stats, want.stats, atol=0.02)


def test_ufpmp_det_eval_reads_orbax_directories(tmp_path):
    """The JAX package's orbax checkpoints (weights-only trees written by
    its ``save_checkpoint``) serve the tool as the same weights' state-dict
    files do: the same detections, bit for bit, and COCO stats."""
    import glsdet_tpu.train.loop as jloop
    from glsdet_tpu.config import apply_overrides as japply
    from glsdet_tpu.config import get_config as jget_config
    from test_torch_orbax_full import seeded_variables

    ckpts = {}
    for key, name, opts, seed in (("coarse", "coarse_det", COARSE_OPTS, 5),
                                  ("mp", "mp_det_res50", MP_OPTS, 6)):
        v = seeded_variables(japply(jget_config(name), dict(opts)), seed)
        tree = {"params": v["params"], "batch_stats": v["batch_stats"],
                "ema_params": v["params"]}
        orbax_dir = jloop.save_checkpoint(str(tmp_path / key), tree, 1)
        pt = str(tmp_path / f"{key}.pt")
        torch.save(state_dict_from_flax(v), pt)
        ckpts[key] = (orbax_dir, pt)
    frames = (FRAMES[0],) * 2
    gts = {i: [([10.0, 12.0, 30.0, 25.0], i)] for i in range(2)}
    ann, img_root = _write_set(str(tmp_path), gts=gts, frames=frames)
    dumps, stats = [], []
    for route in (0, 1):
        out = str(tmp_path / f"dets{route}.json")
        res, st = ttool.main([
            "coarse_det", ckpts["coarse"][route], "mp_det_res50",
            ckpts["mp"][route], ann, img_root, "--fuse-global",
            "--first-options", *_opts(COARSE_OPTS),
            "--second-options", *_opts(MP_OPTS), "--out-json", out,
            "--device", "cpu"])
        with open(out) as f:
            dumps.append(json.load(f))
        stats.append(res.stats)
    assert len(dumps[0]) > 0 and dumps[0] == dumps[1]
    np.testing.assert_array_equal(stats[0], stats[1])
