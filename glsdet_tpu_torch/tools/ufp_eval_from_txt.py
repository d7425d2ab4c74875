"""Two-stage eval from pre-computed detection-txt directories, the
counterpart of ``tools/ufp_eval_from_txt.py`` (behavioral reference:
``yolox-ufp/myufp_eval.py:316-335``): the full-image and the UFP (local,
already in frame coordinates) detections of each frame are read from
per-image txt directories written by another trainer (yolox-drone's
``get_map_txt``), fused by class-wise NMS (``eval/fusion.py``, kernel B2
on the card, on ``--device``), optionally filtered by the frames' ignore
regions (``eval/ignore.py``, the UAVDT protocol), and scored with the
COCO evaluator.

    python -m glsdet_tpu_torch.tools.ufp_eval_from_txt ann.json global_txt/ ufp_txt/ \\
        --classes visdrone
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from glsdet_tpu_torch.tools.common import (add_device_arg, class_names,
                                           dataset_gts, padded_dets,
                                           xyxy_to_xywh)


def main(argv=None):
    """Fuse and score; returns the ``CocoEvalResult``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ann_file")
    ap.add_argument("global_dir", help="full-image detection txts")
    ap.add_argument("local_dir", help="UFP/local detection txts "
                                      "(already in original coords)")
    ap.add_argument("--classes", default="visdrone")
    ap.add_argument("--iou-thr", type=float, default=0.65)
    ap.add_argument("--filter-ignore", action="store_true",
                    help="drop detections centered in ignore regions "
                         "(UAVDT protocol, uav_eval.py)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from glsdet_tpu_torch.apis import load_det_txt
    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.eval.coco_eval import CocoEvaluator, summarize
    from glsdet_tpu_torch.eval.fusion import fuse_detections
    from glsdet_tpu_torch.eval.ignore import filter_ignore_regions
    from glsdet_tpu_torch.models.build import resolve_device

    dev = resolve_device(args.device)
    names = class_names(args.classes)
    ds = CocoDataset(args.ann_file, img_root="")
    empty = (np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
             np.zeros(0, np.int64))

    dets = {}
    for rec in ds.records:
        stem = os.path.splitext(os.path.basename(rec.file_name))[0]
        ga = os.path.join(args.global_dir, stem + ".txt")
        lo = os.path.join(args.local_dir, stem + ".txt")
        gb = load_det_txt(ga, names) if os.path.exists(ga) else empty
        lb = load_det_txt(lo, names) if os.path.exists(lo) else empty
        fused = fuse_detections(padded_dets(*gb, 500, dev),
                                padded_dets(*lb, 500, dev),
                                args.iou_thr, 500)
        v = fused["valid"].cpu().numpy()
        boxes = fused["boxes"].cpu().numpy()[v]
        scores = fused["scores"].cpu().numpy()[v]
        labels = fused["labels"].cpu().numpy()[v]
        if args.filter_ignore:
            boxes, scores, labels = filter_ignore_regions(
                boxes, scores, labels, ds.ignore_regions.get(rec.img_id))
        dets[rec.img_id] = (xyxy_to_xywh(boxes), scores, labels)

    res = CocoEvaluator(len(names)).evaluate(dataset_gts(ds), dets)
    print(summarize(res, names))
    return res


if __name__ == "__main__":
    main()
