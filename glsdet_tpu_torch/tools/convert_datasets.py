"""Dataset converters CLI, the counterpart of ``tools/convert_datasets.py``
(behavioral reference: ``UFPMP-Det-Tools/build_dataset/VisDrone2COCO.py``
and ``UAVDT2COCO.py``), over ``data/{visdrone,uavdt,voc,coco}.py``:

    python -m glsdet_tpu_torch.tools.convert_datasets visdrone <root> <out.json>
    python -m glsdet_tpu_torch.tools.convert_datasets uavdt <root> <out.json> --split test
    python -m glsdet_tpu_torch.tools.convert_datasets voc <root> <out.json> --classes visdrone
    python -m glsdet_tpu_torch.tools.convert_datasets images <img_dir> <out.json> --classes visdrone
    python -m glsdet_tpu_torch.tools.convert_datasets coco2voc <ann.json> <dst_root>
"""

from __future__ import annotations

import argparse
import json

from glsdet_tpu_torch.data.coco import images_to_coco
from glsdet_tpu_torch.data.uavdt import uavdt_to_coco
from glsdet_tpu_torch.data.visdrone import visdrone_to_coco
from glsdet_tpu_torch.data.voc import coco_to_voc, voc_to_coco
from glsdet_tpu_torch.tools.common import class_names


def main(argv=None):
    """Convert; returns the COCO dict written (``coco2voc``: the number of
    XML files)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset", choices=["visdrone", "uavdt", "voc",
                                        "images", "coco2voc"])
    ap.add_argument("root", help="dataset root (coco2voc: input json)")
    ap.add_argument("out_json", help="output json (coco2voc: dst root)")
    ap.add_argument("--split", default="train",
                    choices=["train", "val", "test", "trainval"])
    ap.add_argument("--image-dir", default="images")
    ap.add_argument("--anno-dir", default="annotations")
    ap.add_argument("--classes", default="visdrone",
                    help="voc only: 'visdrone', 'uavdt', or a "
                         "comma-separated class list")
    args = ap.parse_args(argv)

    if args.dataset == "coco2voc":
        with open(args.root) as f:
            coco = json.load(f)
        n = coco_to_voc(coco, args.out_json, split=args.split)
        print(f"{n} xml annotations -> {args.out_json}/VOC2007")
        return n
    if args.dataset == "images":
        coco = images_to_coco(args.root, args.out_json,
                              class_names(args.classes))
        print(f"{len(coco['images'])} images (no annotations) "
              f"-> {args.out_json}")
        return coco
    if args.dataset == "voc":
        coco = voc_to_coco(args.root, args.out_json,
                           class_names(args.classes), split=args.split)
    elif args.dataset == "visdrone":
        coco = visdrone_to_coco(args.root, args.out_json,
                                image_dir=args.image_dir,
                                anno_dir=args.anno_dir)
    else:
        coco = uavdt_to_coco(args.root, args.out_json, split=args.split)
    print(f"{len(coco['images'])} images, "
          f"{len(coco['annotations'])} annotations -> {args.out_json}")
    return coco


if __name__ == "__main__":
    main()
