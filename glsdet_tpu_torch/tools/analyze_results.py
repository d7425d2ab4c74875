"""Rank eval images by per-image mAP and dump annotated best/worst, the
counterpart of ``tools/analyze_results.py`` (behavioral reference:
``yolox-ufp/tools/analysis_tools/analyze_results.py``): score every
image's predictions against its GT, then save the top-k highest- and
lowest-scoring images with ground truth and predictions drawn, as
``good/`` and ``bad/`` subdirs.  Input is the detections json that
``tools.test --out`` writes.

    python -m glsdet_tpu_torch.tools.analyze_results dets.json \\
        --ann val.json --img-root images --out-dir analysis

Each image is written as ``<stem>_map<AP>.png`` (``image_io.write_png``)
with the boxes as outlines in their class colour, without label text
(``utils/visualize.py``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def per_image_map(evaluator, gts, dets, img_id):
    empty = (np.zeros((0, 4)), np.zeros((0,)), np.zeros((0,), np.int64))
    res = evaluator.evaluate({img_id: gts[img_id]},
                             {img_id: dets.get(img_id, empty)})
    return res.ap


def main(argv=None):
    """Score and draw; returns ``[(AP, img_id)]`` in ascending AP."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("results", help="detections json (tools/test.py --out)")
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-root", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--topk", type=int, default=20)
    ap.add_argument("--show-score-thr", type=float, default=0.3)
    args = ap.parse_args(argv)

    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.data.image_io import write_png
    from glsdet_tpu_torch.eval.coco_eval import CocoEvaluator
    from glsdet_tpu_torch.tools.common import dataset_gts
    from glsdet_tpu_torch.tools.eval_metric import load_results
    from glsdet_tpu_torch.utils.visualize import draw_detections

    dataset = CocoDataset(args.ann, args.img_root)
    dets = load_results(args.results, dataset.cat_to_contig)
    gts = dataset_gts(dataset)
    evaluator = CocoEvaluator(len(dataset.class_names))

    scored = sorted(
        ((per_image_map(evaluator, gts, dets, rec.img_id), rec)
         for rec in dataset.records),
        key=lambda t: t[0])
    picks = ([("bad", s, r) for s, r in scored[:args.topk]]
             + [("good", s, r) for s, r in scored[-args.topk:]])

    for kind in ("good", "bad"):
        os.makedirs(os.path.join(args.out_dir, kind), exist_ok=True)
    for kind, score, rec in picks:
        img = dataset.load_image(rec)
        # GT in class colors, predictions overlaid in uniform style
        img = draw_detections(img, rec.boxes,
                              np.ones(len(rec.boxes)), rec.labels,
                              dataset.class_names, 0.0)
        if rec.img_id in dets:
            xywh, ss, ll = dets[rec.img_id]
            xyxy = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]],
                                  axis=1)
            img = draw_detections(img, xyxy, ss, ll, dataset.class_names,
                                  args.show_score_thr)
        stem = os.path.splitext(os.path.basename(rec.file_name))[0]
        write_png(os.path.join(args.out_dir, kind,
                               f"{stem}_map{score:.3f}.png"),
                  np.asarray(img, np.uint8))
    mean = float(np.mean([s for s, _ in scored]))
    print(f"{len(scored)} images, mean per-image AP {mean:.4f}; "
          f"wrote {args.topk} best + {args.topk} worst -> {args.out_dir}")
    return [(s, r.img_id) for s, r in scored]


if __name__ == "__main__":
    main()
