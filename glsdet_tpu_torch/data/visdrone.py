"""VisDrone annotation -> COCO json converter, the port's copy of
``glsdet_tpu.data.visdrone`` (reference:
``UFPMP-Det-Tools/build_dataset/VisDrone2COCO.py``): per-image txt lines
``x,y,w,h,score,category,trunc,occ``; category 0 ("ignored regions") is
kept in the ``ignore_regions`` side list, 11 ("others") and boxes without
area are dropped, and ``category_id = category - 1`` gives the 10
VisDrone classes.

Image sizes come from the PNG or JPEG header (``image_io.image_size``)
where the JAX package asks PIL; the json is the same
(``tests/test_torch_data.py``).
"""

from __future__ import annotations

import json
import os

from glsdet_tpu_torch.data.image_io import image_size

VISDRONE_CLASSES = (
    "pedestrian", "people", "bicycle", "car", "van", "truck",
    "tricycle", "awning-tricycle", "bus", "motor",
)


def parse_visdrone_txt(txt_path: str):
    """Parse one VisDrone annotation file.

    Returns (boxes_xywh, labels_1based, ignore_boxes_xywh)."""
    boxes, labels, ignores = [], [], []
    with open(txt_path) as f:
        for line in f:
            line = line.strip().strip(",")
            if not line:
                continue
            parts = line.split(",")
            x, y, w, h = (float(v) for v in parts[:4])
            cat = int(parts[5])
            if cat == 0:
                ignores.append([x, y, w, h])
                continue
            if cat == 11 or w <= 0 or h <= 0:
                continue
            boxes.append([x, y, w, h])
            labels.append(cat)
    return boxes, labels, ignores


def visdrone_to_coco(visdrone_root: str, out_json: str,
                     image_dir: str = "images",
                     anno_dir: str = "annotations",
                     with_ignore: bool = True) -> dict:
    """Convert a VisDrone split directory to a COCO-format dict + json file.

    Layout: ``<root>/<image_dir>/*.jpg`` + ``<root>/<anno_dir>/*.txt``.
    """
    img_root = os.path.join(visdrone_root, image_dir)
    ann_root = os.path.join(visdrone_root, anno_dir)
    images, annotations, ignore_regions = [], [], []
    ann_id = 1
    names = sorted(n for n in os.listdir(img_root)
                   if n.lower().endswith((".jpg", ".jpeg", ".png")))
    for img_id, name in enumerate(names, start=1):
        path = os.path.join(img_root, name)
        w, h = image_size(path)
        images.append({
            "id": img_id, "file_name": name, "width": w, "height": h,
        })
        txt = os.path.join(ann_root, os.path.splitext(name)[0] + ".txt")
        if not os.path.exists(txt):
            continue
        boxes, labels, ignores = parse_visdrone_txt(txt)
        for box, cat in zip(boxes, labels):
            annotations.append({
                "id": ann_id,
                "image_id": img_id,
                "category_id": cat - 1,
                "bbox": box,
                "area": box[2] * box[3],
                "iscrowd": 0,
            })
            ann_id += 1
        if with_ignore:
            for box in ignores:
                ignore_regions.append({"image_id": img_id, "bbox": box})

    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [
            {"id": i, "name": n, "supercategory": "none"}
            for i, n in enumerate(VISDRONE_CLASSES)
        ],
    }
    if with_ignore:
        coco["ignore_regions"] = ignore_regions
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(coco, f)
    return coco
