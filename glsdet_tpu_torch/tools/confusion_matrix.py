"""Confusion-matrix analysis from COCO-format detections, the
counterpart of ``tools/confusion_matrix.py`` (behavioral reference:
``yolox-ufp/tools/analysis_tools/confusion_matrix.py``): per-(gt-class,
det-class) counts at an IoU threshold, including background row/column
(missed GTs / false positives), normalized per GT class, and a png plot.

    python -m glsdet_tpu_torch.tools.confusion_matrix val.json dets.json

The plot is a heat map of the normalized matrix on the Blues ramp, one
block per cell (rows GT classes, columns predicted classes, background
last), drawn in numpy without text (``utils/plot.py``: the GPU machine
has neither matplotlib nor a font).
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np


def compute_confusion(gts, dets, num_classes, iou_thr=0.5,
                      score_thr=0.3):
    """gts {img: (boxes xyxy, labels)}, dets {img: (boxes, scores,
    labels)} -> (C+1, C+1) matrix (last = background)."""
    mat = np.zeros((num_classes + 1, num_classes + 1))
    for img_id, (gb, gl) in gts.items():
        db, ds, dl = dets.get(img_id, (np.zeros((0, 4)), np.zeros(0),
                                       np.zeros(0, np.int64)))
        keep = ds >= score_thr
        db, ds, dl = db[keep], ds[keep], dl[keep]
        order = np.argsort(-ds)
        db, dl = db[order], dl[order]
        g_used = np.zeros(len(gb), bool)
        for b, l in zip(db, dl):
            if len(gb) == 0:
                mat[num_classes, l] += 1
                continue
            ix1 = np.maximum(b[0], gb[:, 0])
            iy1 = np.maximum(b[1], gb[:, 1])
            ix2 = np.minimum(b[2], gb[:, 2])
            iy2 = np.minimum(b[3], gb[:, 3])
            inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0,
                                                          None)
            union = ((b[2] - b[0]) * (b[3] - b[1])
                     + (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
                     - inter)
            ious = inter / np.maximum(union, 1e-12)
            j = int(np.argmax(ious))
            if ious[j] >= iou_thr and not g_used[j]:
                g_used[j] = True
                mat[gl[j], l] += 1
            else:
                mat[num_classes, l] += 1  # fp (background row)
        for used, l in zip(g_used, gl):
            if not used:
                mat[l, num_classes] += 1  # missed gt
    return mat


def main(argv=None):
    """Print the normalized matrix and write the plot; returns it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ann_file")
    ap.add_argument("det_json", help="COCO-format detection json")
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--out", default="confusion.png")
    args = ap.parse_args(argv)

    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.data.image_io import write_png
    from glsdet_tpu_torch.utils.plot import heat_map

    ds = CocoDataset(args.ann_file, img_root="")
    gts = {r.img_id: (r.boxes, r.labels) for r in ds.records}
    with open(args.det_json) as f:
        raw = json.load(f)
    by_img = defaultdict(list)
    for d in raw:
        by_img[d["image_id"]].append(d)
    cat_to_contig = ds.cat_to_contig
    dets = {}
    for img_id, items in by_img.items():
        boxes = np.array([[d["bbox"][0], d["bbox"][1],
                           d["bbox"][0] + d["bbox"][2],
                           d["bbox"][1] + d["bbox"][3]] for d in items])
        scores = np.array([d["score"] for d in items])
        labels = np.array([cat_to_contig[d["category_id"]]
                           for d in items], np.int64)
        dets[img_id] = (boxes, scores, labels)

    mat = compute_confusion(gts, dets, len(ds.class_names), args.iou,
                            args.score_thr)
    names = ds.class_names + ["background"]
    norm = mat / np.maximum(mat.sum(axis=1, keepdims=True), 1)
    print("rows = GT class, cols = predicted class (normalized):")
    print("  " + " ".join(f"{n[:8]:>8s}" for n in names))
    for i, n in enumerate(names):
        print(f"{n[:12]:>12s} " + " ".join(
            f"{norm[i, j]:8.2f}" for j in range(len(names))))
    write_png(args.out, heat_map(norm))
    print(f"wrote {args.out}")
    return norm


if __name__ == "__main__":
    main()
