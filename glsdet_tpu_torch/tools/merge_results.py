"""Global-local result fusion CLI, the counterpart of
``tools/merge_results.py`` (behavioral reference:
``yolox-drone/merge_results.py``): two detection json files (the
full-image "global" pass and the UFP "local" pass) merged per image by
class-wise NMS at IoU 0.65 (kernel B2 on the card) or gaussian soft-NMS
(``--soft``), ranked to ``--max-dets``, written as COCO-format
detections.  The fusion (``eval/fusion.py: fuse_detections``) runs on
``--device``.

    python -m glsdet_tpu_torch.tools.merge_results global.json local.json fused.json
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np

from glsdet_tpu_torch.eval.fusion import fuse_detections
from glsdet_tpu_torch.tools.common import add_device_arg, padded_dets


def load_dets(path):
    with open(path) as f:
        dets = json.load(f)
    by_img = defaultdict(list)
    for d in dets:
        by_img[d["image_id"]].append(d)
    return by_img


def to_padded(dlist, k: int, device) -> dict:
    """The first ``k`` COCO-format detections of an image as the fusion's
    padded rows (:func:`common.padded_dets`), xywh -> xyxy."""
    xywh = np.asarray([d["bbox"] for d in dlist[:k]],
                      np.float64).reshape(-1, 4)
    return padded_dets(
        np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], axis=1),
        [d["score"] for d in dlist[:k]],
        [d["category_id"] for d in dlist[:k]], k, device)


def main(argv=None) -> list:
    """Fuse the two files; returns the fused detections written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("global_json")
    ap.add_argument("local_json")
    ap.add_argument("out_json")
    ap.add_argument("--iou-thr", type=float, default=0.65)
    ap.add_argument("--soft", action="store_true", help="gaussian soft-NMS")
    ap.add_argument("--max-dets", type=int, default=500)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from glsdet_tpu_torch.models.build import resolve_device

    dev = resolve_device(args.device)
    ga = load_dets(args.global_json)
    lb = load_dets(args.local_json)
    img_ids = sorted(set(ga) | set(lb))

    k = args.max_dets
    fused_out = []
    for img_id in img_ids:
        f = fuse_detections(to_padded(ga.get(img_id, []), k, dev),
                            to_padded(lb.get(img_id, []), k, dev),
                            args.iou_thr, k, use_soft=args.soft)
        v = f["valid"].cpu().numpy()
        boxes = f["boxes"].cpu().numpy()[v]
        scores = f["scores"].cpu().numpy()[v]
        labels = f["labels"].cpu().numpy()[v]
        for b, s, lab in zip(boxes, scores, labels):
            fused_out.append({
                "image_id": int(img_id),
                "category_id": int(lab),
                "bbox": [float(b[0]), float(b[1]),
                         float(b[2] - b[0]), float(b[3] - b[1])],
                "score": float(s),
            })
    with open(args.out_json, "w") as f:
        json.dump(fused_out, f)
    print(f"fused {len(img_ids)} images -> {len(fused_out)} detections")
    return fused_out


if __name__ == "__main__":
    main()
