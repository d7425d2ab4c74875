"""Draw boxes from COCO json / VOC xml / txt dirs onto images, the
counterpart of ``tools/draw_bbox.py``.

Behavioral reference: ``yolox-drone/tools/basetools/draw_bbox.py``
(DrawBBox over CoCo json or VOC xml annotation sources) and
``basetools/txt_visual.py`` (ground-truth / detection txt lines, with
``--prob`` switching between ``<name> <x1> <y1> <x2> <y2>`` and
``<name> <conf> <x1> <y1> <x2> <y2>`` formats — the same txt contract as
tools.get_map).  Usage:

    python -m glsdet_tpu_torch.tools.draw_bbox --coco ann.json --img-root imgs/ --out vis/
    python -m glsdet_tpu_torch.tools.draw_bbox --voc Annotations/ --img-root imgs/ --out vis/
    python -m glsdet_tpu_torch.tools.draw_bbox --txt detection-results/ --prob \\
        --img-root imgs/ --out vis/ [--score-thr 0.3]

Images are read with ``data/image_io.py: read_image`` (a missing or
unreadable file is skipped, as ``cv2.imread``'s ``None`` is) and written
under their own name in the format of its extension
(``image_io.write_image``); boxes are outlines in their class colour,
without label text (``utils/visualize.py``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def _iter_coco(path):
    with open(path) as f:
        coco = json.load(f)
    names = {c["id"]: c["name"] for c in coco.get("categories", [])}
    cat_index = {cid: i for i, cid in enumerate(sorted(names))}
    per_image = {}
    for ann in coco.get("annotations", []):
        per_image.setdefault(ann["image_id"], []).append(ann)
    class_names = [names[cid] for cid in sorted(names)]
    for img in coco.get("images", []):
        anns = per_image.get(img["id"], [])
        boxes = np.array([[a["bbox"][0], a["bbox"][1],
                           a["bbox"][0] + a["bbox"][2],
                           a["bbox"][1] + a["bbox"][3]] for a in anns],
                         np.float32).reshape(-1, 4)
        labels = np.array([cat_index[a["category_id"]] for a in anns],
                          np.int32)
        yield img["file_name"], boxes, np.ones(len(anns), np.float32), \
            labels, class_names


def _iter_voc(ann_dir, img_ext):
    import xml.etree.ElementTree as ET

    names = []
    parsed = []
    for xml_path in sorted(glob.glob(os.path.join(ann_dir, "*.xml"))):
        root = ET.parse(xml_path).getroot()
        fname = root.findtext("filename") or (
            os.path.splitext(os.path.basename(xml_path))[0] + img_ext)
        boxes, labels = [], []
        for obj in root.iter("object"):
            name = obj.findtext("name")
            if name not in names:
                names.append(name)
            bb = obj.find("bndbox")
            boxes.append([float(bb.findtext(k)) for k in
                          ("xmin", "ymin", "xmax", "ymax")])
            labels.append(names.index(name))
        parsed.append((fname, np.array(boxes, np.float32).reshape(-1, 4),
                       np.array(labels, np.int32)))
    for fname, boxes, labels in parsed:
        yield fname, boxes, np.ones(len(boxes), np.float32), labels, names


def _iter_txt(txt_dir, prob, img_ext):
    names = []
    parsed = []
    for txt_path in sorted(glob.glob(os.path.join(txt_dir, "*.txt"))):
        stem = os.path.splitext(os.path.basename(txt_path))[0]
        boxes, scores, labels = [], [], []
        with open(txt_path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if prob:  # <name> <conf> <x1> <y1> <x2> <y2>
                    name, conf, coords = parts[0], float(parts[1]), parts[2:6]
                else:     # <name> <x1> <y1> <x2> <y2>
                    name, conf, coords = parts[0], 1.0, parts[1:5]
                if name not in names:
                    names.append(name)
                boxes.append([float(c) for c in coords])
                scores.append(conf)
                labels.append(names.index(name))
        parsed.append((stem + img_ext,
                       np.array(boxes, np.float32).reshape(-1, 4),
                       np.array(scores, np.float32),
                       np.array(labels, np.int32)))
    for fname, boxes, scores, labels in parsed:
        yield fname, boxes, scores, labels, names


def main(argv=None):
    """Draw every source image; returns the paths written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--coco", help="COCO annotation json")
    src.add_argument("--voc", help="VOC Annotations/ xml dir")
    src.add_argument("--txt", help="per-image txt dir (get_map format)")
    ap.add_argument("--img-root", required=True)
    ap.add_argument("--out", required=True, help="output image dir")
    ap.add_argument("--prob", action="store_true",
                    help="txt lines carry a confidence column "
                         "(detection-results format)")
    ap.add_argument("--score-thr", type=float, default=0.0)
    ap.add_argument("--img-ext", default=".jpg",
                    help="image extension for voc/txt stems")
    ap.add_argument("--max-images", type=int)
    args = ap.parse_args(argv)

    from glsdet_tpu_torch.data.image_io import read_image, write_image
    from glsdet_tpu_torch.utils.visualize import draw_detections

    if args.coco:
        items = _iter_coco(args.coco)
    elif args.voc:
        items = _iter_voc(args.voc, args.img_ext)
    else:
        items = _iter_txt(args.txt, args.prob, args.img_ext)

    os.makedirs(args.out, exist_ok=True)
    written = []
    for fname, boxes, scores, labels, class_names in items:
        if args.max_images is not None and len(written) >= args.max_images:
            break
        path = os.path.join(args.img_root, fname)
        try:
            img = read_image(path)
        except FileNotFoundError:
            print(f"skip (unreadable): {path}")
            continue
        vis = draw_detections(img, boxes, scores, labels,
                              class_names, score_thr=args.score_thr)
        out_path = os.path.join(args.out, os.path.basename(fname))
        write_image(out_path, vis)
        written.append(out_path)
    print(f"wrote {len(written)} images to {args.out}")
    return written


if __name__ == "__main__":
    main()
