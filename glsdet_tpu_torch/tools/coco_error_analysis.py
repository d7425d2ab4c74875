"""COCO error analysis CLI, the counterpart of
``tools/coco_error_analysis.py`` (behavioral reference:
``yolox-ufp/tools/analysis_tools/coco_error_analysis.py``): per-class
precision-recall breakdown isolating error types: score at strict IoU
(0.75), loose IoU (0.5) and localization-forgiven (0.1), with one PR
panel per class.

    python -m glsdet_tpu_torch.tools.coco_error_analysis val.json dets.json

Each panel (``<out-dir>/<class>.png``) draws the three precision curves
over recall in [0, 1] (IoU .75 blue, .5 orange, .1 green, matplotlib's
colour cycle), in numpy without text (``utils/plot.py``: the GPU machine
has neither matplotlib nor a font).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np


def main(argv=None):
    """Print the per-class rows and write the panels; returns the rows
    ``(name, AP75, AP50, loc-forgiven)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ann_file")
    ap.add_argument("det_json")
    ap.add_argument("--out-dir", default="error_analysis")
    args = ap.parse_args(argv)

    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.data.image_io import write_png
    from glsdet_tpu_torch.eval.coco_eval import REC_THRS, CocoEvaluator
    from glsdet_tpu_torch.utils.plot import CYCLE, line_plot

    ds = CocoDataset(args.ann_file, img_root="")
    gts = {}
    for rec in ds.records:
        b = rec.boxes
        gts[rec.img_id] = (
            np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], axis=1),
            rec.labels)
    with open(args.det_json) as f:
        raw = json.load(f)
    by_img = defaultdict(list)
    for d in raw:
        by_img[d["image_id"]].append(d)
    dets = {}
    for img_id, items in by_img.items():
        boxes = np.array([d["bbox"] for d in items], np.float64)
        scores = np.array([d["score"] for d in items])
        labels = np.array([ds.cat_to_contig[d["category_id"]]
                           for d in items], np.int64)
        dets[img_id] = (boxes, scores, labels)

    k = len(ds.class_names)
    # three evaluations: strict (.75), loose (.5), localization-forgiven (.1)
    res75 = CocoEvaluator(k, iou_thrs=np.array([0.75])).evaluate(gts, dets)
    res50 = CocoEvaluator(k, iou_thrs=np.array([0.5])).evaluate(gts, dets)
    res10 = CocoEvaluator(k, iou_thrs=np.array([0.1])).evaluate(gts, dets)

    os.makedirs(args.out_dir, exist_ok=True)
    mind = 2  # largest maxDets; area 'all' (precision is (T,R,K,A,M))
    rows = []
    for ki, name in enumerate(ds.class_names):
        p75 = res75.precision[0, :, ki, 0, mind]
        p50 = res50.precision[0, :, ki, 0, mind]
        p10 = res10.precision[0, :, ki, 0, mind]
        if (p50 < 0).all():
            continue
        c75 = float(np.mean(p75[p75 > -1])) if (p75 > -1).any() else 0.0
        c50 = float(np.mean(p50[p50 > -1])) if (p50 > -1).any() else 0.0
        c10 = float(np.mean(p10[p10 > -1])) if (p10 > -1).any() else 0.0
        rows.append((name, c75, c50, c10))
        print(f"{name:>18s}: AP75={c75:.3f}  AP50={c50:.3f}  "
              f"Loc-forgiven={c10:.3f}  "
              f"(loc error costs {c10 - c50:.3f}, "
              f"strictness costs {c50 - c75:.3f})")

    for ki, name in enumerate(ds.class_names):
        p50 = res50.precision[0, :, ki, 0, mind]
        if (p50 < 0).all():
            continue
        curves = []
        for res, color in zip((res75, res50, res10), CYCLE):
            p = res.precision[0, :, ki, 0, mind].copy()
            p[p < 0] = 0
            curves.append((REC_THRS, p, color))
        write_png(os.path.join(args.out_dir, f"{name}.png"),
                  line_plot(curves, x_range=(0.0, 1.0), y_range=(0.0, 1.0)))
    print(f"wrote PR panels to {args.out_dir}/")
    return rows


if __name__ == "__main__":
    main()
