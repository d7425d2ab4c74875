"""UAVDT annotation -> COCO json converter, carried over from the JAX
package's ``data/uavdt.py`` (host code, no OpenCV).

Behavioral reference: ``UFPMP-Det-Tools/build_dataset/UAVDT2COCO.py`` —
sequences ``M0101..``, ground truth ``<seq>_gt_whole.txt`` lines
``frame,obj_id,x,y,w,h,oov,occ,category`` with 3 classes (car, truck,
bus), frames as ``img<frame:06d>.jpg`` inside each sequence dir, and a
hardcoded held-out test-sequence list (UAVDT2COCO.py:23-25).

Each frame's size comes from its JPEG header (``image_io.image_size``)
where the frame is on disk, else it is UAVDT's 1024 x 540; ``img_w`` and
``img_h`` fix it for every frame, as the JAX package's defaults do.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, Optional

from glsdet_tpu_torch.data.image_io import image_size

UAVDT_CLASSES = ("car", "truck", "bus")

# Standard UAVDT benchmark test sequences (UAVDT2COCO.py:23-25).
UAVDT_TEST_SEQS = (
    "M0203", "M0205", "M0208", "M0209", "M0403", "M0601", "M0602",
    "M0606", "M0701", "M0801", "M0802", "M1001", "M1004", "M1007",
    "M1009", "M1101", "M1301", "M1302", "M1303", "M1401",
)


def uavdt_to_coco(uavdt_root: str, out_json: str, split: str = "train",
                  gt_dir: str = "GT", seq_dir: str = "UAV-benchmark-M",
                  img_w: Optional[int] = None,
                  img_h: Optional[int] = None) -> dict:
    """Convert UAVDT to COCO. split: 'train' (non-test seqs) or 'test'.
    Frames live in ``<uavdt_root>/<seq_dir>/<seq>/``."""
    gt_root = os.path.join(uavdt_root, gt_dir)
    images, annotations = [], []
    img_ids: Dict[str, int] = {}
    ann_id = 1
    next_img = 1
    seqs = sorted(
        f[: -len("_gt_whole.txt")]
        for f in os.listdir(gt_root) if f.endswith("_gt_whole.txt"))
    want_test = split == "test"
    seqs = [s for s in seqs if (s in UAVDT_TEST_SEQS) == want_test]

    for seq in seqs:
        per_frame = defaultdict(list)
        with open(os.path.join(gt_root, f"{seq}_gt_whole.txt")) as f:
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 9:
                    continue
                frame = int(parts[0])
                x, y, w, h = (float(v) for v in parts[2:6])
                cat = int(parts[8])
                if w <= 0 or h <= 0 or not 1 <= cat <= 3:
                    continue
                per_frame[frame].append((x, y, w, h, cat))
        for frame, objs in sorted(per_frame.items()):
            fname = os.path.join(seq, f"img{frame:06d}.jpg")
            if fname not in img_ids:
                img_ids[fname] = next_img
                path = os.path.join(uavdt_root, seq_dir, fname)
                w0, h0 = (image_size(path) if img_w is None
                          and img_h is None and os.path.exists(path)
                          else (1024, 540))
                images.append({
                    "id": next_img, "file_name": fname,
                    "width": w0 if img_w is None else img_w,
                    "height": h0 if img_h is None else img_h,
                })
                next_img += 1
            for x, y, w, h, cat in objs:
                annotations.append({
                    "id": ann_id,
                    "image_id": img_ids[fname],
                    "category_id": cat - 1,
                    "bbox": [x, y, w, h],
                    "area": w * h,
                    "iscrowd": 0,
                })
                ann_id += 1

    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [
            {"id": i, "name": n, "supercategory": "none"}
            for i, n in enumerate(UAVDT_CLASSES)
        ],
    }
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(coco, f)
    return coco
