"""Pascal-VOC-layout annotation converter, carried over from the JAX
package's ``data/voc.py`` (host code, no OpenCV).

Behavioral reference: ``yolox-drone/voc_annotation.py`` — reads
``Annotations/*.xml`` + ``ImageSets/Main/<split>.txt`` under a VOC-layout
root (the layout yolox-drone expects its VisDrone exports in) and emits
training lists.  Here the converter targets the framework's single
dataset contract (COCO json) instead of the reference's txt lines, and
can also emit the reference's txt-line format for cross-checking.

Sizes come from each xml's ``<size>``; where an xml has none, from the
image's header (``image_io.image_size``) when the image is on disk (the
JAX package writes 0 x 0 there).
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence, Tuple

from glsdet_tpu_torch.data.image_io import image_size


def parse_voc_xml(path: str, class_to_id: dict) -> Tuple[list, list, tuple]:
    """One VOC xml -> (boxes xyxy, label ids, (width, height)).

    Unknown class names and ``difficult`` objects are skipped (the
    reference's voc_annotation.py behavior)."""
    root = ET.parse(path).getroot()
    size = root.find("size")
    wh = (int(size.find("width").text), int(size.find("height").text)) \
        if size is not None else (0, 0)
    boxes, labels = [], []
    for obj in root.iter("object"):
        name = obj.find("name").text.strip()
        if name not in class_to_id:
            continue
        difficult = obj.find("difficult")
        if difficult is not None and difficult.text and \
                int(difficult.text) == 1:
            continue
        bb = obj.find("bndbox")
        box = [float(bb.find(k).text)
               for k in ("xmin", "ymin", "xmax", "ymax")]
        if box[2] <= box[0] or box[3] <= box[1]:
            continue
        boxes.append(box)
        labels.append(class_to_id[name])
    return boxes, labels, wh


def voc_to_coco(voc_root: str, out_json: str,
                class_names: Sequence[str],
                split: str = "train",
                image_dir: str = "JPEGImages",
                anno_dir: str = "Annotations",
                image_set_dir: str = "ImageSets/Main",
                ids: Optional[List[str]] = None) -> dict:
    """Convert a VOC-layout directory to a COCO-format dict + json file.

    ``ids``: explicit image-id list; default reads
    ``<root>/<image_set_dir>/<split>.txt``.
    """
    class_to_id = {n: i for i, n in enumerate(class_names)}
    if ids is None:
        set_file = os.path.join(voc_root, image_set_dir, f"{split}.txt")
        with open(set_file) as f:
            ids = [line.strip().split()[0] for line in f if line.strip()]

    images, annotations = [], []
    ann_id = 1
    for img_idx, image_id in enumerate(ids, start=1):
        xml_path = os.path.join(voc_root, anno_dir, f"{image_id}.xml")
        boxes, labels, (w, h) = parse_voc_xml(xml_path, class_to_id)
        img_path = os.path.join(voc_root, image_dir, f"{image_id}.jpg")
        if (w, h) == (0, 0) and os.path.exists(img_path):
            w, h = image_size(img_path)
        images.append({
            "id": img_idx,
            "file_name": f"{image_id}.jpg",
            "width": w,
            "height": h,
        })
        for box, label in zip(boxes, labels):
            x1, y1, x2, y2 = box
            annotations.append({
                "id": ann_id,
                "image_id": img_idx,
                "category_id": label + 1,   # COCO ids are 1-based
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "area": (x2 - x1) * (y2 - y1),
                "iscrowd": 0,
            })
            ann_id += 1

    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i + 1, "name": n}
                       for i, n in enumerate(class_names)],
    }
    if out_json:
        os.makedirs(os.path.dirname(os.path.abspath(out_json)),
                    exist_ok=True)
        with open(out_json, "w") as f:
            json.dump(coco, f)
    return coco


def coco_to_voc(coco: dict, dst_root: str, split: str = "train",
                database: str = "glsdet") -> int:
    """Write a VOC2007-layout dataset skeleton from a COCO dict.

    Behavioral reference: ``yolox-drone/tools/basetools/
    format_converter.py`` (annotation -> VOC xml templates) +
    ``init_datasets.py`` (VOC2007 directory skeleton with
    Annotations/ ImageSets/Main/ JPEGImages/).  Images themselves are
    not copied — ``JPEGImages/`` is created for the caller to populate
    (the reference copies from a hardcoded source dir).

    Returns the number of xml files written.
    """
    sec = os.path.join(dst_root, "VOC2007")
    ann_dir = os.path.join(sec, "Annotations")
    set_dir = os.path.join(sec, "ImageSets", "Main")
    img_dir = os.path.join(sec, "JPEGImages")
    for d in (ann_dir, set_dir, img_dir):
        os.makedirs(d, exist_ok=True)

    names = {c["id"]: c["name"] for c in coco.get("categories", [])}
    by_img = {}
    for a in coco.get("annotations", []):
        by_img.setdefault(a["image_id"], []).append(a)

    stems = []
    for img in coco.get("images", []):
        stem = os.path.splitext(os.path.basename(img["file_name"]))[0]
        stems.append(stem)
        root = ET.Element("annotation")
        ET.SubElement(root, "folder").text = "VOC2007"
        ET.SubElement(root, "filename").text = os.path.basename(
            img["file_name"])
        src = ET.SubElement(root, "source")
        ET.SubElement(src, "database").text = database
        size = ET.SubElement(root, "size")
        ET.SubElement(size, "width").text = str(img.get("width", 0))
        ET.SubElement(size, "height").text = str(img.get("height", 0))
        ET.SubElement(size, "depth").text = "3"
        ET.SubElement(root, "segmented").text = "0"
        for a in by_img.get(img["id"], []):
            x, y, w, h = a["bbox"]
            obj = ET.SubElement(root, "object")
            ET.SubElement(obj, "name").text = names.get(
                a["category_id"], str(a["category_id"]))
            ET.SubElement(obj, "pose").text = "Unspecified"
            ET.SubElement(obj, "truncated").text = "0"
            ET.SubElement(obj, "difficult").text = str(
                int(a.get("iscrowd", 0)))
            bb = ET.SubElement(obj, "bndbox")
            ET.SubElement(bb, "xmin").text = str(int(round(x)))
            ET.SubElement(bb, "ymin").text = str(int(round(y)))
            ET.SubElement(bb, "xmax").text = str(int(round(x + w)))
            ET.SubElement(bb, "ymax").text = str(int(round(y + h)))
        ET.ElementTree(root).write(os.path.join(ann_dir, stem + ".xml"))

    with open(os.path.join(set_dir, f"{split}.txt"), "w") as f:
        f.write("\n".join(stems) + ("\n" if stems else ""))
    return len(stems)


def voc_to_txt_lines(voc_root: str, class_names: Sequence[str],
                     split: str = "train",
                     image_dir: str = "JPEGImages") -> List[str]:
    """Emit the reference's txt-line format
    (``<img_path> x1,y1,x2,y2,cls ...`` per voc_annotation.py) for
    cross-checks against yolox-drone tooling."""
    coco = voc_to_coco(voc_root, "", class_names, split,
                       image_dir=image_dir)
    by_img = {}
    for a in coco["annotations"]:
        by_img.setdefault(a["image_id"], []).append(a)
    lines = []
    for img in coco["images"]:
        path = os.path.join(voc_root, image_dir, img["file_name"])
        parts = [path]
        for a in by_img.get(img["id"], []):
            x, y, w, h = a["bbox"]
            parts.append(f"{int(x)},{int(y)},{int(x + w)},{int(y + h)},"
                         f"{a['category_id'] - 1}")
        lines.append(" ".join(parts))
    return lines
