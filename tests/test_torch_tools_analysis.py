"""The port's eight host analysis commands against the JAX package's
CLIs, both run in this process on the same seeded inputs:
``optimize_anchors``, ``analyze_dataset`` (table and ``--json``),
``analyze_logs`` (``cal_train_time``, ``plot_curve``),
``coco_error_analysis``, ``confusion_matrix``, ``draw_bbox`` (COCO, VOC
and txt sources), ``browse_dataset`` and ``analyze_results``.

- The printed lines are equal, numbers included (anchors, statistics,
  train time, per-class AP75/AP50/loc-forgiven, the confusion matrix).
- The drawing commands select the same images, write them under the
  same names and draw the same boxes: each package's ``draw_detections``
  is replaced by a recorder around the port's (the JAX one draws label
  text with OpenCV, the port outlines only), so the written images are
  equal pixel for pixel too (JPEG through the same encoder's bytes).
- The plots are PNGs of the shared numpy plotter (``utils/plot.py``);
  ``LossHistory``'s ``epoch_loss.png`` keeps the bytes it had before the
  plotter was factored out (digests taken from that code)."""

import hashlib
import json
import os

import numpy as np
import pytest

import glsdet_tpu.utils.visualize  # noqa: F401  (patched by name)
import glsdet_tpu_torch.utils.visualize as pvis
from glsdet_tpu_torch.data.image_io import read_image
from glsdet_tpu_torch.tools import (analyze_dataset, analyze_logs,
                                    analyze_results, browse_dataset,
                                    coco_error_analysis, confusion_matrix,
                                    draw_bbox, optimize_anchors)
from glsdet_tpu_torch.utils.observe import LossHistory
from torch_tools_util import CAT_IDS, ROOT, run_jax, write_set

FRAMES = [(96, 160), (80, 120), (64, 64), (100, 75), (90, 150), (120, 120)]
DRAW = pvis.draw_detections


def _gts(rs):
    gts = {}
    for i, (h, w) in enumerate(FRAMES):
        rows = []
        for _ in range(rs.randint(3, 9)):
            bw, bh = rs.uniform(4, min(w, h) / 2, 2)
            x, y = rs.uniform(0, w - bw), rs.uniform(0, h - bh)
            rows.append((np.array([x, y, bw, bh]), int(rs.randint(0, 4))))
        gts[i] = rows
    return gts


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A COCO set with ground truth in four classes, detections near it
    (jittered, some relabelled, plus false positives), a training log,
    and VOC / txt annotation directories."""
    root = str(tmp_path_factory.mktemp("analysis"))
    rs = np.random.RandomState(0)
    gts = _gts(rs)
    ann, img_root = write_set(root, FRAMES, gts=gts)
    dets = []
    for i, rows in gts.items():
        for box, lab in rows:
            if rs.rand() < 0.2:
                continue
            lab = lab if rs.rand() > 0.15 else int(rs.randint(0, 4))
            dets.append({"image_id": 100 + i, "category_id": CAT_IDS[lab],
                         "bbox": [float(v) for v in
                                  box + rs.uniform(-3, 3, 4)],
                         "score": float(rs.uniform(0.05, 1))})
        for _ in range(3):
            dets.append({"image_id": 100 + i,
                         "category_id": CAT_IDS[int(rs.randint(0, 4))],
                         "bbox": [float(v) for v in
                                  rs.uniform([0, 0, 3, 3], [50, 50, 30, 30])],
                         "score": float(rs.uniform(0.05, 1))})
    det_json = os.path.join(root, "dets.json")
    with open(det_json, "w") as f:
        json.dump(dets, f)
    log = os.path.join(root, "train.log.json")
    with open(log, "w") as f:
        for step in range(1, 41):
            f.write(json.dumps({"step": step, "epoch": 1 + step // 20,
                                "loss": float(5 / step + rs.rand()),
                                "loss_cls": float(rs.rand()),
                                "time": float(rs.uniform(0.1, 0.3))}) + "\n")
            if step % 10 == 0:
                f.write(json.dumps({"step": step, "bbox_mAP": 0.01 * step})
                        + "\n")
    voc = os.path.join(root, "voc")
    txt = os.path.join(root, "txt")
    os.makedirs(voc)
    os.makedirs(txt)
    for i, rows in gts.items():
        objs = "".join(
            f"<object><name>c{CAT_IDS[lab]}</name><bndbox><xmin>{b[0]:.1f}"
            f"</xmin><ymin>{b[1]:.1f}</ymin><xmax>{b[0] + b[2]:.1f}</xmax>"
            f"<ymax>{b[1] + b[3]:.1f}</ymax></bndbox></object>"
            for b, lab in rows)
        with open(os.path.join(voc, f"{i}.xml"), "w") as f:
            f.write(f"<annotation><filename>{i}.png</filename>{objs}"
                    "</annotation>")
        with open(os.path.join(txt, f"{i}.txt"), "w") as f:
            for b, lab in rows:
                f.write(f"c{CAT_IDS[lab]} {rs.uniform(0, 1):.3f} {b[0]:.1f} "
                        f"{b[1]:.1f} {b[0] + b[2]:.1f} {b[1] + b[3]:.1f}\n")
    return {"root": root, "ann": ann, "img_root": img_root,
            "dets": det_json, "log": log, "voc": voc, "txt": txt}


def _both(capsys, name, port_main, argv, patches=None, jax_argv=None):
    """Run the JAX CLI on ``jax_argv`` (default ``argv``) and the port's
    ``main`` on ``argv``; returns (JAX stdout, port stdout, port's
    return value)."""
    capsys.readouterr()
    run_jax(name, jax_argv or argv, **(patches or {}))
    want = capsys.readouterr().out
    got_ret = port_main([str(a) for a in argv])
    return want, capsys.readouterr().out, got_ret


class Recorder:
    """A ``draw_detections`` that records its arguments and draws as the
    port does."""

    def __init__(self):
        self.calls = []

    def __call__(self, img, boxes, scores, labels, class_names=None,
                 score_thr=0.3, thickness=2):
        self.calls.append((np.asarray(img).copy(), np.asarray(boxes),
                           np.asarray(scores), np.asarray(labels),
                           list(class_names or []), float(score_thr)))
        return DRAW(img, boxes, scores, labels, class_names, score_thr,
                    thickness)


def _same_calls(a, b):
    assert len(a.calls) == len(b.calls) > 0
    for x, y in zip(a.calls, b.calls):
        np.testing.assert_array_equal(x[0], y[0])
        for u, v in zip(x[1:4], y[1:4]):
            np.testing.assert_allclose(np.asarray(u, np.float64),
                                       np.asarray(v, np.float64), rtol=0,
                                       atol=0)
        assert x[4:] == y[4:]


def _drawn(monkeypatch, name, port_main, argv, jax_out, port_out,
           jax_argv=None, capsys=None):
    """Run both drawing CLIs with recorders; returns (JAX stdout, port
    stdout) and checks the recorded draws and the written files."""
    jrec, prec = Recorder(), Recorder()
    monkeypatch.setattr(pvis, "draw_detections", prec)
    want, got, _ = _both(
        capsys, name, port_main, argv,
        {"glsdet_tpu.utils.visualize:draw_detections": jrec},
        jax_argv=jax_argv)
    _same_calls(jrec, prec)
    files = sorted(os.path.relpath(os.path.join(d, n), jax_out)
                   for d, _, ns in os.walk(jax_out) for n in ns)
    assert files == sorted(os.path.relpath(os.path.join(d, n), port_out)
                           for d, _, ns in os.walk(port_out) for n in ns)
    assert files
    for f in files:
        np.testing.assert_array_equal(read_image(os.path.join(port_out, f)),
                                      read_image(os.path.join(jax_out, f)))
    return want.replace(jax_out, port_out), got


def test_optimize_anchors(data, capsys):
    want, got, anchors = _both(capsys, "optimize_anchors",
                               optimize_anchors.main,
                               [data["ann"], "--k", "4", "--iters", "20"])
    assert got == want and anchors.shape == (4, 2)


@pytest.mark.parametrize("extra", [[], ["--json"]])
def test_analyze_dataset(data, capsys, extra):
    want, got, stats = _both(capsys, "analyze_dataset",
                             analyze_dataset.main, [data["ann"], *extra])
    assert got == want and stats["_total"]["images"] == len(FRAMES)


def test_analyze_logs_train_time(data, capsys):
    want, got, times = _both(capsys, "analyze_logs", analyze_logs.main,
                             ["cal_train_time", data["log"]])
    assert got == want and len(times) == 40


def test_analyze_logs_plot_curve(data, capsys, tmp_path):
    jout, pout = str(tmp_path / "j.png"), str(tmp_path / "p.png")
    argv = ["plot_curve", data["log"], "--keys", "loss", "bbox_mAP"]
    want, got, img = _both(capsys, "analyze_logs", analyze_logs.main,
                           [*argv, "--out", pout],
                           jax_argv=[*argv, "--out", jout])
    assert got == want.replace(jout, pout) and os.path.exists(jout)
    np.testing.assert_array_equal(read_image(pout), img)
    # both curves are drawn in the colour cycle's first two colours
    for color in [(31, 119, 180), (255, 127, 14)]:
        assert (img == color).all(-1).sum() > 50


def test_coco_error_analysis(data, capsys, tmp_path):
    jout, pout = str(tmp_path / "j"), str(tmp_path / "p")
    argv = [data["ann"], data["dets"]]
    want, got, rows = _both(capsys, "coco_error_analysis",
                            coco_error_analysis.main,
                            [*argv, "--out-dir", pout],
                            jax_argv=[*argv, "--out-dir", jout])
    assert got == want.replace(jout, pout) and len(rows) == 4
    assert sorted(os.listdir(pout)) == sorted(os.listdir(jout))
    assert read_image(os.path.join(pout, os.listdir(pout)[0])).shape == (
        480, 640, 3)


@pytest.mark.parametrize("extra", [[], ["--iou", "0.3", "--score-thr",
                                        "0.5"]])
def test_confusion_matrix(data, capsys, tmp_path, extra):
    jout, pout = str(tmp_path / "j.png"), str(tmp_path / "p.png")
    argv = [data["ann"], data["dets"], *extra]
    want, got, norm = _both(capsys, "confusion_matrix",
                            confusion_matrix.main, [*argv, "--out", pout],
                            jax_argv=[*argv, "--out", jout])
    n = len(CAT_IDS) + 1                 # the classes and background
    assert got == want.replace(jout, pout) and norm.shape == (n, n)
    assert read_image(pout).shape == (n * 40 + 40, n * 40 + 40, 3)


@pytest.mark.parametrize("source", ["coco", "voc", "txt"])
def test_draw_bbox(data, capsys, tmp_path, monkeypatch, source):
    jout, pout = str(tmp_path / "j"), str(tmp_path / "p")
    src = {"coco": ["--coco", data["ann"]],
           "voc": ["--voc", data["voc"], "--img-ext", ".png"],
           "txt": ["--txt", data["txt"], "--prob", "--img-ext", ".png",
                   "--score-thr", "0.3", "--max-images", "4"]}[source]
    argv = [*src, "--img-root", data["img_root"]]
    want, got = _drawn(monkeypatch, "draw_bbox", draw_bbox.main,
                       [*argv, "--out", pout], jout, pout,
                       jax_argv=[*argv, "--out", jout], capsys=capsys)
    assert got == want


def test_draw_bbox_skips_what_it_cannot_read(data, capsys, tmp_path):
    ann = json.load(open(data["ann"]))
    ann["images"].append({"id": 999, "file_name": "missing.png",
                          "width": 8, "height": 8})
    path = str(tmp_path / "ann.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    argv = ["--coco", path, "--img-root", data["img_root"]]
    want, got, written = _both(capsys, "draw_bbox", draw_bbox.main,
                               [*argv, "--out", str(tmp_path / "p")],
                               jax_argv=[*argv, "--out", str(tmp_path / "j")])
    assert got == want.replace(str(tmp_path / "j"), str(tmp_path / "p"))
    assert "skip (unreadable)" in got and len(written) == len(FRAMES)


@pytest.mark.parametrize("extra", [[], ["--no-aug", "--seed", "3"]])
def test_browse_dataset(data, capsys, tmp_path, monkeypatch, extra):
    jout, pout = str(tmp_path / "j"), str(tmp_path / "p")
    base = [data["ann"], data["img_root"]]
    opts = ["--num", "4", "--img-hw", "64", "96", *extra]
    want, got = _drawn(monkeypatch, "browse_dataset", browse_dataset.main,
                       [*base, pout, *opts], jout, pout,
                       jax_argv=[*base, jout, *opts], capsys=capsys)
    assert got == want


def test_analyze_results(data, capsys, tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    jout, pout = str(tmp_path / "j"), str(tmp_path / "p")
    argv = [data["dets"], "--ann", data["ann"], "--img-root",
            data["img_root"], "--topk", "2", "--show-score-thr", "0.2"]
    want, got = _drawn(monkeypatch, "analyze_results", analyze_results.main,
                       [*argv, "--out-dir", pout], jout, pout,
                       jax_argv=[*argv, "--out-dir", jout], capsys=capsys)
    assert got == want
    # the per-image AP is in the names: some good, some bad
    assert any("_map0.000" not in n for n in os.listdir(os.path.join(
        pout, "good")))


# the sha256 of epoch_loss.png as LossHistory drew it before the plotter
# was shared (utils/observe.py, the code of the parent commit)
LOSS_PNG = {
    "one": ([2.5], [],
            "e91444640d63dc15000a3059de4af8944e282849d14171425793d4f693ae855d"),
    "val": ([3.0, 2.0, 1.5], [3.2, 2.4, 2.0],
            "6edc2f9bb8f2d20ea3f857fa85eb410543a189d34337e8ac63152de8804fd822"),
    "smooth": ([5.0, 4.1, 3.9, 3.0, 2.2, 2.4, 1.7, 1.5],
               [5.2, 4.4, 4.0, 3.3, 2.6, 2.5, 2.1, 1.9],
               "43a0250494d23a9a99afa545bcc8f282d3a1485bc5d5a213b54ffde9fef3429f"),
}


@pytest.mark.parametrize("case", sorted(LOSS_PNG))
def test_epoch_loss_png_keeps_its_bytes(tmp_path, case):
    train, val, digest = LOSS_PNG[case]
    hist = LossHistory(str(tmp_path))
    for i, loss in enumerate(train):
        hist.append_loss(loss, val[i] if val else None)
    with open(tmp_path / "epoch_loss.png", "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == digest
