"""VOC-style mAP CLI from detection / ground-truth txt directories, the
counterpart of ``tools/get_map.py`` (behavioral reference:
``yolox-drone/get_map.py`` + ``get_map_txt*.py``): scores
``detection-results/<id>.txt`` (lines ``<name> <conf> <x1> <y1> <x2>
<y2>``) against ``ground-truth/<id>.txt`` (lines ``<name> <x1> <y1> <x2>
<y2>``) at one IoU with ``eval/voc_map.py``; ``--coco`` adds COCO AP over
the same sets (``eval/coco_eval.py``).  Host only.

    python -m glsdet_tpu_torch.tools.get_map ground-truth/ detection-results/ --coco
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from glsdet_tpu_torch.eval.coco_eval import CocoEvaluator, summarize
from glsdet_tpu_torch.eval.voc_map import eval_voc_map
from glsdet_tpu_torch.tools.common import class_names, xyxy_to_xywh


def read_gt_txt(path, name_to_id):
    boxes, labels = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            boxes.append([float(v) for v in parts[-4:]])
            labels.append(name_to_id[" ".join(parts[:-4])])
    return (np.asarray(boxes, np.float64).reshape(-1, 4),
            np.asarray(labels, np.int64))


def read_det_txt(path, name_to_id):
    boxes, scores, labels = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            boxes.append([float(v) for v in parts[-4:]])
            scores.append(float(parts[-5]))
            labels.append(name_to_id[" ".join(parts[:-5])])
    return (np.asarray(boxes, np.float64).reshape(-1, 4),
            np.asarray(scores, np.float64),
            np.asarray(labels, np.int64))


def main(argv=None):
    """Score the directories; returns (the VOC result, the COCO result or
    None)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("gt_dir")
    ap.add_argument("det_dir")
    ap.add_argument("--classes", default="visdrone",
                    help="'visdrone', 'uavdt', or comma-separated names")
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--coco", action="store_true",
                    help="also run COCO AP@[.5:.95]")
    args = ap.parse_args(argv)

    names = class_names(args.classes)
    name_to_id = {n: i for i, n in enumerate(names)}
    gts, dets = {}, {}
    ids = sorted(os.path.splitext(f)[0]
                 for f in os.listdir(args.gt_dir) if f.endswith(".txt"))
    for i, img_id in enumerate(ids):
        gts[i] = read_gt_txt(
            os.path.join(args.gt_dir, img_id + ".txt"), name_to_id)
        det_path = os.path.join(args.det_dir, img_id + ".txt")
        if os.path.exists(det_path):
            dets[i] = read_det_txt(det_path, name_to_id)
        else:
            dets[i] = (np.zeros((0, 4)), np.zeros((0,)),
                       np.zeros((0,), np.int64))

    res = eval_voc_map(gts, dets, len(names), iou_thr=args.iou)
    print(f"mAP@{args.iou:.2f} = {res['map']:.4f}")
    for k, v in res["per_class"].items():
        print(f"  {names[k]:>18s}: AP={v['ap']:.4f} lamr={v['lamr']:.4f} "
              f"(gt {v['n_gt']}, det {v['n_det']})")

    coco = None
    if args.coco:
        cgts = {k: (xyxy_to_xywh(v[0]), v[1]) for k, v in gts.items()}
        cdets = {k: (xyxy_to_xywh(v[0]), v[1], v[2])
                 for k, v in dets.items()}
        coco = CocoEvaluator(len(names)).evaluate(cgts, cdets)
        print(summarize(coco, names))
    return res, coco


if __name__ == "__main__":
    main()
