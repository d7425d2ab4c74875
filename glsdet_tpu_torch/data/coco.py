"""COCO-format dataset reader + fixed-shape batch construction, the
port's copy of ``glsdet_tpu.data.coco`` (reference:
``yolox-ufp/mmdet/datasets/coco.py`` / ``VisDrone.py:19``): a COCO-style
index with per-image annotation lookup, the training filter of empty
images, the ``ignore_regions`` side list, and GTs padded to ``max_gt``
with a validity mask so that every batch has fixed shapes.

The one change: frames are read with ``data/image_io.py`` (JPEG, PNG and
``.npy``), not ``cv2.imread``, which the GPU machine lacks; the pixels are
the same (``image_io`` decodes JPEG as ``cv2.imread`` does).  The decode
cache (``cache_images``, insert until ``cache_bytes``, no eviction) is
per process: each of the loader's worker processes fills its own
(``__getstate__`` hands workers the index without the frames).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from glsdet_tpu_torch.data.image_io import image_size, read_image


@dataclass
class CocoRecord:
    img_id: int
    file_name: str
    width: int
    height: int
    boxes: np.ndarray   # (n, 4) xyxy float32
    labels: np.ndarray  # (n,) int32 contiguous [0, num_classes)


class CocoDataset:
    """Index of a COCO json; images loaded lazily by the pipeline."""

    def __init__(self, ann_file: str, img_root: str,
                 filter_empty: bool = False,
                 cache_images: bool = False,
                 cache_bytes: int = 4 << 30):
        with open(ann_file) as f:
            coco = json.load(f)
        self.img_root = img_root
        # decoded-image RAM cache (the yolox-drone dataloader's
        # cache-in-RAM training mode analog): mosaic reads 4 images per
        # sample, so on a CPU-starved host jpeg/png decode dominates the
        # input pipeline.  Insert-until-budget, no eviction — datasets
        # that fit are fully resident, larger ones cache a stable prefix.
        self.cache_images = cache_images
        self.cache_bytes = int(cache_bytes)
        self._cache: Dict[int, np.ndarray] = {}
        self._cache_used = 0
        # budget check+insert is check-then-act across threads
        self._cache_lock = threading.Lock()
        self.categories = sorted(
            coco.get("categories", []), key=lambda c: c["id"])
        self.cat_ids = [c["id"] for c in self.categories]
        self.cat_to_contig = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.class_names = [c["name"] for c in self.categories]

        anns_by_img: Dict[int, list] = {}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.records: List[CocoRecord] = []
        for img in coco["images"]:
            anns = anns_by_img.get(img["id"], [])
            if filter_empty and not anns:
                continue
            boxes = np.array(
                [[a["bbox"][0], a["bbox"][1],
                  a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
                 for a in anns], np.float32).reshape(-1, 4)
            labels = np.array(
                [self.cat_to_contig[a["category_id"]] for a in anns],
                np.int32)
            self.records.append(CocoRecord(
                img["id"], img["file_name"], img["width"], img["height"],
                boxes, labels))

        self.ignore_regions: Dict[int, np.ndarray] = {}
        for r in coco.get("ignore_regions", []):
            x, y, w, h = r["bbox"]
            box = np.array([[x, y, x + w, y + h]], np.float32)
            prev = self.ignore_regions.get(r["image_id"])
            self.ignore_regions[r["image_id"]] = (
                box if prev is None else np.concatenate([prev, box]))

    def __len__(self):
        return len(self.records)

    def __getstate__(self):
        # the loader's worker processes get the index, not the lock or the
        # decoded frames: each worker fills a cache of its own
        state = dict(self.__dict__)
        state["_cache"], state["_cache_used"] = {}, 0
        del state["_cache_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._cache_lock = threading.Lock()

    def load_image(self, rec: CocoRecord) -> np.ndarray:
        if self.cache_images:
            cached = self._cache.get(rec.img_id)
            if cached is not None:
                return cached
        path = os.path.join(self.img_root, rec.file_name)
        img = read_image(path)  # RGB uint8
        if self.cache_images:
            with self._cache_lock:
                if self._cache_used + img.nbytes <= self.cache_bytes:
                    img.setflags(write=False)  # shared across threads
                    self._cache[rec.img_id] = img
                    self._cache_used += img.nbytes
        return img


# ImageNet mean/std of the mmdet pipelines (configs *img_norm_cfg*).
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def normalize(img: np.ndarray, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> np.ndarray:
    return (img.astype(np.float32) - mean) / std


def pad_gts(boxes: np.ndarray, labels: np.ndarray,
            max_gt: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad/truncate GTs to (max_gt, ...) with a validity mask."""
    n = min(len(boxes), max_gt)
    out_boxes = np.zeros((max_gt, 4), np.float32)
    out_labels = np.zeros((max_gt,), np.int32)
    out_valid = np.zeros((max_gt,), bool)
    out_boxes[:n] = boxes[:n]
    out_labels[:n] = labels[:n]
    out_valid[:n] = True
    return out_boxes, out_labels, out_valid


def make_batch(samples: Sequence[dict]) -> dict:
    """Stack per-sample dicts (images already same shape) into arrays."""
    return {
        k: np.stack([s[k] for s in samples], axis=0)
        for k in samples[0]
    }


def images_to_coco(img_dir: str, out_json: str = "",
                   class_names: Sequence[str] = (),
                   exts: Sequence[str] = (".jpg", ".jpeg", ".png", ".bmp"),
                   read_sizes: bool = True) -> dict:
    """Annotation-less COCO json from a directory of images.

    Behavioral reference: ``yolox-ufp/tools/dataset_converters/
    images2coco.py`` — wraps unlabeled images so inference/test tooling
    (tools/test.py --format-only, browse_dataset) can run on them.
    ``read_sizes=False`` skips reading the headers (width/height set to
    0); the JAX package decodes each image for its size, the port reads
    the PNG or JPEG header (``image_io.image_size``).
    """
    files = sorted(f for f in os.listdir(img_dir)
                   if os.path.splitext(f)[1].lower() in exts)
    images = []
    for i, name in enumerate(files, start=1):
        w = h = 0
        if read_sizes:
            w, h = image_size(os.path.join(img_dir, name))
        images.append({"id": i, "file_name": name,
                       "width": w, "height": h})
    coco = {
        "images": images,
        "annotations": [],
        "categories": [{"id": i + 1, "name": n}
                       for i, n in enumerate(class_names)],
    }
    if out_json:
        os.makedirs(os.path.dirname(os.path.abspath(out_json)),
                    exist_ok=True)
        with open(out_json, "w") as f:
            json.dump(coco, f)
    return coco
