"""The port's host-side commands against the JAX package's CLIs, both run
here in this process with the same seeded inputs: ``print_config`` (the
same text), ``convert_datasets`` (every mode: equal json and VOC xml
files), ``get_map`` and ``eval_metric`` (the same printed results),
``merge_results`` (an equal fused json, soft-NMS scores within 1e-6
relative; the fusion on the CPU here, B2 on the card) and ``ufp_eval_from_txt`` (the same printed COCO summary)."""

import json
import os

import numpy as np
import pytest

import glsdet_tpu.eval.coco_eval  # noqa: F401
from glsdet_tpu_torch.data.image_io import write_jpeg
from glsdet_tpu_torch.data.visdrone import VISDRONE_CLASSES
from glsdet_tpu_torch.tools import (convert_datasets, eval_metric, get_map,
                                    merge_results, print_config,
                                    ufp_eval_from_txt)
from torch_tools_util import run_jax


def _both(capsys, name, port_main, argv, port_extra=(), outs=None):
    """Run the JAX CLI and the port's ``main`` on ``argv`` (the port's
    with ``port_extra`` too, and each path of ``outs`` (JAX's, port's) in
    argv replaced by the port's); returns (JAX stdout, port stdout,
    port's return value)."""
    capsys.readouterr()
    run_jax(name, argv)
    want = capsys.readouterr().out
    if outs:
        argv = [outs[1] if a == outs[0] else a for a in argv]
    got_ret = port_main([str(a) for a in argv] + list(port_extra))
    got = capsys.readouterr().out
    return want, got, got_ret


@pytest.mark.parametrize("argv", [
    ["coarse_det"],
    ["mp_det_res50", "--cfg-options", "train.base_lr=0.02",
     "data.img_hw=(512,512)", "model.depth=18"],
    ["yolox_ffa", "--cfg-options", "eval.score_thr=0.3",
     "data.mosaic=False", "train.work_dir=somewhere"],
])
def test_print_config(capsys, argv):
    want, got, text = _both(capsys, "print_config", print_config.main, argv)
    assert got == want and text + "\n" == got and len(got) > 1000


# -- convert_datasets ---------------------------------------------------------

def _visdrone_root(root):
    rs = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "annotations"))
    for i, (h, w) in enumerate([(60, 90), (48, 64), (70, 50)]):
        write_jpeg(os.path.join(root, "images", f"{i:04d}.jpg"),
                   rs.randint(0, 255, (h, w, 3), np.uint8))
        lines = []
        for _ in range(5):
            bw, bh = rs.randint(2, 20, 2)
            x, y = rs.randint(0, w - bw), rs.randint(0, h - bh)
            cat = int(rs.choice([0, 1, 4, 10, 11]))
            lines.append(f"{x},{y},{bw},{bh},{int(cat not in (0, 11))},"
                         f"{cat},0,{rs.randint(0, 3)}")
        with open(os.path.join(root, "annotations", f"{i:04d}.txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def _uavdt_root(root):
    os.makedirs(os.path.join(root, "GT"))
    rs = np.random.RandomState(1)
    for seq in ("M0101", "M0203"):
        rows = [f"{fr},{k},{rs.randint(0, 900)},{rs.randint(0, 500)},"
                f"{rs.randint(1, 60)},{rs.randint(1, 40)},1,1,"
                f"{rs.randint(0, 5)}"
                for fr in (1, 2, 3) for k in range(3)]
        with open(os.path.join(root, "GT", f"{seq}_gt_whole.txt"),
                  "w") as f:
            f.write("\n".join(rows) + "\n")
    return root


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_convert_datasets_every_mode(tmp_path, capsys):
    vis = _visdrone_root(str(tmp_path / "vis"))
    uav = _uavdt_root(str(tmp_path / "uav"))
    cases = [
        ("visdrone", vis, []), ("images", os.path.join(vis, "images"),
                                ["--classes", "a,b,c"]),
        ("uavdt", uav, []), ("uavdt", uav, ["--split", "test"])]
    for k, (mode, root, extra) in enumerate(cases):
        jout, tout = tmp_path / f"j{k}.json", tmp_path / f"t{k}.json"
        want, got, coco = _both(capsys, "convert_datasets",
                                convert_datasets.main,
                                [mode, root, jout, *extra],
                                outs=(jout, tout))
        assert got.replace(str(tout), "OUT") == want.replace(str(jout),
                                                             "OUT")
        with open(jout) as f:
            want_json = json.load(f)
        with open(tout) as f:
            assert json.load(f) == want_json == json.loads(json.dumps(coco))
        assert want_json["images"]
    # coco2voc of the VisDrone json, then voc back to COCO
    jdst, tdst = tmp_path / "jvoc", tmp_path / "tvoc"
    want, got, n = _both(capsys, "convert_datasets", convert_datasets.main,
                         ["coco2voc", tmp_path / "t0.json", jdst,
                          "--split", "val"], outs=(jdst, tdst))
    assert n == 3 and _files(tdst) == _files(jdst) != {}
    jout, tout = tmp_path / "jv.json", tmp_path / "tv.json"
    _both(capsys, "convert_datasets", convert_datasets.main,
          ["voc", os.path.join(tdst, "VOC2007"), jout, "--split", "val"],
          outs=(jout, tout))
    with open(jout) as f, open(tout) as g:
        want_json = json.load(f)
        assert json.load(g) == want_json and want_json["annotations"]


# -- get_map / eval_metric ------------------------------------------------------

def _txt_dirs(root, names, seed=0, n_img=4):
    rs = np.random.RandomState(seed)
    gt, det = os.path.join(root, "gt"), os.path.join(root, "det")
    os.makedirs(gt)
    os.makedirs(det)
    for i in range(n_img):
        g_lines, d_lines = [], []
        for _ in range(rs.randint(2, 7)):
            x, y = rs.uniform(0, 200, 2)
            w, h = rs.uniform(5, 40, 2)
            c = names[rs.randint(len(names))]
            g_lines.append(f"{c} {x:.1f} {y:.1f} {x + w:.1f} {y + h:.1f}")
            if rs.rand() < 0.8:
                j = rs.uniform(-3, 3, 4)
                d_lines.append(f"{c} {rs.rand():.4f} {x + j[0]:.2f} "
                               f"{y + j[1]:.2f} {x + w + j[2]:.2f} "
                               f"{y + h + j[3]:.2f}")
        for _ in range(rs.randint(0, 3)):
            x, y = rs.uniform(0, 200, 2)
            d_lines.append(f"{names[rs.randint(len(names))]} "
                           f"{rs.rand():.4f} {x:.1f} {y:.1f} {x + 9:.1f} "
                           f"{y + 9:.1f}")
        with open(os.path.join(gt, f"f{i}.txt"), "w") as f:
            f.write("\n".join(g_lines) + "\n")
        if i != 2:                       # one frame without detections
            with open(os.path.join(det, f"f{i}.txt"), "w") as f:
                f.write("\n".join(d_lines) + "\n")
    return gt, det


@pytest.mark.parametrize("extra", [[], ["--coco"],
                                   ["--iou", "0.6", "--coco"]])
def test_get_map(tmp_path, capsys, extra):
    gt, det = _txt_dirs(str(tmp_path), list(VISDRONE_CLASSES))
    want, got, (res, coco) = _both(capsys, "get_map", get_map.main,
                                   [gt, det, *extra])
    assert got == want and "mAP@" in got and res["map"] > 0
    assert (coco is not None) == ("--coco" in extra)


def test_get_map_custom_classes(tmp_path, capsys):
    gt, det = _txt_dirs(str(tmp_path), ["car", "truck"], seed=3)
    want, got, _ = _both(capsys, "get_map", get_map.main,
                         [gt, det, "--classes", "car,truck", "--coco"])
    assert got == want


@pytest.mark.parametrize("max_dets", [[], ["--max-dets", "1", "5", "20"]])
def test_eval_metric(tmp_path, capsys, max_dets):
    from torch_tools_util import CAT_IDS, write_set

    rs = np.random.RandomState(4)
    frames = [(60, 80), (50, 70), (40, 40)]
    gts = {i: [(rs.uniform(0, 30, 4) + [0, 0, 3, 3], rs.randint(10))
               for _ in range(4)] for i in range(3)}
    ann, _ = write_set(str(tmp_path), frames, gts=gts)
    dets = []
    for i, rows in gts.items():
        for box, lab in rows:
            dets.append({"image_id": 100 + i, "category_id": CAT_IDS[lab],
                         "bbox": [float(v) for v in box + rs.uniform(-2, 2,
                                                                     4)],
                         "score": float(rs.rand())})
    path = str(tmp_path / "dets.json")
    with open(path, "w") as f:
        json.dump(dets, f)
    want, got, res = _both(capsys, "eval_metric", eval_metric.main,
                           [path, "--ann", ann, *max_dets])
    # the summary's AP is at the last max_dets: 20 < 500 gives -1 there
    assert got == want and (res.ap > 0 or max_dets)


# -- merge_results / ufp_eval_from_txt -----------------------------------------

def _dets_json(path, seed, n_img=3, per=30, overlap=None):
    """COCO-format detections; ``overlap`` (an earlier list) is copied
    with jitter so that the fusion suppresses rows."""
    rs = np.random.RandomState(seed)
    dets = []
    for i in range(n_img):
        for _ in range(per):
            x, y = rs.uniform(0, 300, 2)
            w, h = rs.uniform(4, 60, 2)
            dets.append({"image_id": i, "category_id": int(rs.randint(10)),
                         "bbox": [float(x), float(y), float(w), float(h)],
                         "score": float(rs.rand())})
    for d in overlap or []:
        j = rs.uniform(-2, 2, 4)
        dets.append(dict(d, bbox=[float(v) for v in np.add(d["bbox"], j)],
                         score=float(rs.rand())))
    with open(path, "w") as f:
        json.dump(dets, f)
    return dets


@pytest.mark.parametrize("extra", [[], ["--soft"],
                                   ["--iou-thr", "0.5", "--max-dets", "40"]])
def test_merge_results(tmp_path, capsys, extra):
    g = _dets_json(tmp_path / "g.json", 0)
    _dets_json(tmp_path / "l.json", 1, n_img=4, overlap=g[::2])
    jout, tout = tmp_path / "j.json", tmp_path / "t.json"
    want, got, fused = _both(
        capsys, "merge_results", merge_results.main,
        [tmp_path / "g.json", tmp_path / "l.json", jout, *extra],
        ["--device", "cpu"], outs=(jout, tout))
    assert got.replace(str(tout), "") == want.replace(str(jout), "")
    with open(jout) as f:
        want_json = json.load(f)
    with open(tout) as f:
        got_json = json.load(f)
    assert got_json == fused
    if "--soft" not in extra:
        assert got_json == want_json
    else:
        # the gaussian decay's exp rounds its last bit either way in XLA
        # and PyTorch: the same rows, scores within 1e-6 relative
        key = ("image_id", "category_id", "bbox")
        assert [[d[k] for k in key] for d in got_json] == \
            [[d[k] for k in key] for d in want_json]
        np.testing.assert_allclose([d["score"] for d in got_json],
                                   [d["score"] for d in want_json],
                                   rtol=1e-6)
    n_in = len(g) + len(g[::2]) + 4 * 30
    # hard NMS drops the jittered copies; soft-NMS decays their scores
    assert 0 < len(want_json) <= n_in
    assert "--soft" in extra or len(want_json) < n_in


@pytest.mark.parametrize("extra", [[], ["--filter-ignore"],
                                   ["--iou-thr", "0.5"]])
def test_ufp_eval_from_txt(tmp_path, capsys, extra):
    from torch_tools_util import write_set

    rs = np.random.RandomState(5)
    frames = [(200, 300), (180, 240), (150, 150), (160, 200)]
    names = list(VISDRONE_CLASSES)
    gts = {i: [(np.r_[rs.uniform(0, 120, 2), rs.uniform(6, 40, 2)],
                rs.randint(10)) for _ in range(6)] for i in range(4)}
    ann, _ = write_set(str(tmp_path), frames, gts=gts,
                       ignore={0: [(0.0, 0.0, 60.0, 60.0)],
                               2: [(50.0, 50.0, 40.0, 30.0)]})
    with open(ann) as f:          # the txt tools name classes, not ids
        coco = json.load(f)
    for c, name in zip(coco["categories"], names):
        c["name"] = name
    with open(ann, "w") as f:
        json.dump(coco, f)
    for key in ("global", "local"):
        os.makedirs(tmp_path / key)
        for i, rows in gts.items():
            if key == "local" and i == 3:
                continue                 # a frame with no local file
            lines = []
            for (x, y, w, h), lab in rows:
                j = rs.uniform(-3, 3, 4)
                lines.append(f"{names[lab]} {rs.rand():.4f} {x + j[0]:.2f} "
                             f"{y + j[1]:.2f} {x + w + j[2]:.2f} "
                             f"{y + h + j[3]:.2f}")
            with open(tmp_path / key / f"{i}.txt", "w") as f:
                f.write("\n".join(lines) + "\n")
    want, got, res = _both(capsys, "ufp_eval_from_txt",
                           ufp_eval_from_txt.main,
                           [ann, tmp_path / "global", tmp_path / "local",
                            *extra], ["--device", "cpu"])
    assert got == want and res.ap > 0
