"""The UFP dataset CLI, the counterpart of ``tools/build_ufp_dataset.py``
(behavioral reference: ``UFPMP-Det-Tools/build_dataset/UFP_VisDrone2COCO.py``):
stage 3 of GLSDet.  The trained coarse detector runs over the train
split; each frame's detections are UFP-packed (scale 2.0 for the dataset
build, ``myufp_eval.py:332``), VisDrone ignore regions are blanked, and
the packed mosaics are written as JPEGs beside ``ufp_train.json``, the
ground truth re-projected into mosaic coordinates (a GT is kept when its
min-area IoF with a region is above ``--iof-thr``; bbox -> ``[n_x + (x -
x1) * s, n_y + (y - y1) * s, w * s, h * s]``):

    python -m glsdet_tpu_torch.tools.build_ufp_dataset coarse_det \\
        work_dirs/coarse_det/epoch_12.pt data/train.json data/images \\
        data/ufp

The checkpoint is ``none`` (the seeded initialisation), a state-dict
file, a training checkpoint of ``train/loop.py`` or an orbax directory
of the JAX package: its EMA weights (``apis.init_detector``).  The coarse
forward and its decode + NMS (kernel B2, once per frame) run on
``--device``; resizing, packing, painting and the JPEG writes run on the
host, as the JAX tool does, with the port's bit-exact twins of OpenCV's
``resize`` and ``imwrite`` (``data/augment.py: resize_u8``,
``data/image_io.py: write_jpeg``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from glsdet_tpu_torch.data.augment import resize_u8
from glsdet_tpu_torch.data.coco import normalize
from glsdet_tpu_torch.eval.postprocess import yolox_postprocess
from glsdet_tpu_torch.native import unified_foreground_packing_native
from glsdet_tpu_torch.tools.common import (add_device_arg, checkpoint_arg,
                                           model_dtype)


def pack_frame(img: np.ndarray, boxes: np.ndarray,
               ignore_regions: Optional[np.ndarray], gt_boxes: np.ndarray,
               gt_labels: np.ndarray, scale: float, iof_thr: float
               ) -> Optional[Tuple[np.ndarray, float, float, List]]:
    """One frame of the build, on the host (``tools/build_ufp_dataset.py:
    94-157``): ``img`` (H, W, 3) RGB uint8, ``boxes`` the coarse
    detections (xyxy float32, frame coordinates), ``ignore_regions``
    (xyxy rows) blanked before packing, the frame's GTs (xyxy, contiguous
    labels).  Returns None when packing finds no region, else ``(mosaic,
    mosaic_w, mosaic_h, annotations)``, each annotation ``(bbox xywh,
    label)`` in mosaic coordinates: a GT's first region whose min-area
    IoF with it exceeds ``iof_thr``.  The arithmetic is the JAX tool's,
    line for line: ``int()`` floors of the regions' float64 fields, the
    crop clipped at the frame's edge then stretched to ``(w*f, h*f)``,
    the IoF in the float types it has there."""
    masked = img.copy()
    for ig in (ignore_regions if ignore_regions is not None else []):
        x1, y1, x2, y2 = (int(v) for v in ig)
        masked[max(y1, 0):max(y2, 0), max(x1, 0):max(x2, 0)] = 0

    h0, w0 = img.shape[:2]
    regions, mw, mh = unified_foreground_packing_native(
        boxes.astype(np.float32), scale, (w0, h0))
    if not regions:
        return None
    mh_i, mw_i = int(mh), int(mw)
    mosaic = np.zeros((mh_i, mw_i, 3), np.uint8)
    for r in regions:
        x1, y1, w, h = int(r.x1), int(r.y1), int(r.w), int(r.h)
        nx, ny, f = int(r.new_x), int(r.new_y), int(r.scale_factor)
        crop = masked[max(y1, 0):y1 + h, max(x1, 0):x1 + w]
        if crop.size == 0 or w * f <= 0 or h * f <= 0:
            continue
        crop = resize_u8(crop, (w * f, h * f))
        ph = min(h * f, mh_i - ny)
        pw = min(w * f, mw_i - nx)
        if ph <= 0 or pw <= 0:
            continue
        mosaic[ny:ny + ph, nx:nx + pw] = crop[:ph, :pw]

    annos = []
    for gb, gl in zip(gt_boxes, gt_labels):
        gx1, gy1, gx2, gy2 = gb
        g_area = max((gx2 - gx1) * (gy2 - gy1), 1e-9)
        for r in regions:
            ix1 = max(gx1, r.x1)
            iy1 = max(gy1, r.y1)
            ix2 = min(gx2, r.x1 + r.w)
            iy2 = min(gy2, r.y1 + r.h)
            inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
            # min-area IoF, the reference's compute_iof gate
            # (UFP_VisDrone2COCO.py:21-35, :187)
            denom = max(min(g_area, r.w * r.h), 1e-9)
            if inter / denom <= iof_thr:
                continue
            s = r.scale_factor
            nb = [r.new_x + (gx1 - r.x1) * s, r.new_y + (gy1 - r.y1) * s,
                  (gx2 - gx1) * s, (gy2 - gy1) * s]
            annos.append((nb, gl))
            break
    return mosaic, mw, mh, annos


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("coarse_cfg")
    ap.add_argument("coarse_ckpt")
    ap.add_argument("ann_file")
    ap.add_argument("img_root")
    ap.add_argument("out_dir")
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--iof-thr", type=float, default=0.9)
    ap.add_argument("--max-images", type=int)
    ap.add_argument("--cfg-options", nargs="*", metavar="KEY=VAL")
    add_device_arg(ap)
    return ap


def make_forward(cfg, model, device: torch.device, dtype: torch.dtype):
    """(h, w, 3) uint8 frame already resized to the model's input ->
    the coarse detections (xyxy float32, input coordinates): the batch-1
    forward and ``yolox_postprocess(score_thr=eval.coarse_score_thr,
    max_dets=200)`` (``tools/build_ufp_dataset.py:72-75``)."""
    img_hw = tuple(cfg.data.img_hw)

    @torch.inference_mode()
    def forward(resized: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(normalize(resized)[None]).to(device)
        cls, reg, obj = model(x.to(dtype).permute(0, 3, 1, 2))
        out = yolox_postprocess(cls, reg, obj, img_hw,
                                score_thr=cfg.eval.coarse_score_thr,
                                max_dets=200)
        valid = out["valid"][0].cpu().numpy()
        return out["boxes"][0].float().cpu().numpy()[valid]

    return forward


def main(argv=None) -> dict:
    """Build the dataset; returns what it wrote and how long it took."""
    args = parser().parse_args(argv)

    from glsdet_tpu_torch.apis import init_detector
    from glsdet_tpu_torch.config import parse_cfg_options
    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.data.image_io import write_jpeg
    from glsdet_tpu_torch.models.build import resolve_device

    dev = resolve_device(args.device)
    cfg, model, _ = init_detector(args.coarse_cfg,
                                  checkpoint_arg(args.coarse_ckpt), True,
                                  parse_cfg_options(args.cfg_options), dev)
    dtype = model_dtype(cfg, dev)
    forward = make_forward(cfg, model.to(dtype), dev, dtype)

    ds = CocoDataset(args.ann_file, args.img_root)
    img_dir = os.path.join(args.out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    ch, cw = cfg.data.img_hw

    images_out, annos_out = [], []
    t0 = time.perf_counter()
    n_frames = 0
    for n, rec in enumerate(ds.records):
        if args.max_images and n >= args.max_images:
            break
        n_frames += 1
        img = ds.load_image(rec)
        h0, w0 = img.shape[:2]
        boxes = forward(resize_u8(img, (cw, ch)))
        boxes *= np.array([w0 / cw, h0 / ch] * 2, np.float32)
        packed = pack_frame(img, boxes, ds.ignore_regions.get(rec.img_id),
                            rec.boxes, rec.labels, args.scale, args.iof_thr)
        if packed is None:
            continue
        mosaic, mw, mh, annos = packed
        fname = f"ufp_{rec.img_id:07d}.jpg"
        write_jpeg(os.path.join(img_dir, fname), mosaic)
        img_id_new = len(images_out) + 1
        images_out.append({"id": img_id_new, "file_name": fname,
                           "width": int(mw), "height": int(mh)})
        for nb, gl in annos:
            annos_out.append({
                "id": len(annos_out) + 1, "image_id": img_id_new,
                "category_id": ds.cat_ids[int(gl)],
                "bbox": [float(v) for v in nb],
                "area": float(nb[2] * nb[3]), "iscrowd": 0,
            })

    out_json = {
        "images": images_out,
        "annotations": annos_out,
        "categories": [
            {"id": cid, "name": n, "supercategory": "none"}
            for cid, n in zip(ds.cat_ids, ds.class_names)
        ],
    }
    with open(os.path.join(args.out_dir, "ufp_train.json"), "w") as f:
        json.dump(out_json, f)
    seconds = time.perf_counter() - t0
    print(f"wrote {len(images_out)} packed images, "
          f"{len(annos_out)} annotations to {args.out_dir}")
    return {"frames": n_frames, "mosaics": len(images_out),
            "annotations": len(annos_out), "seconds": seconds,
            "frames_per_s": n_frames / max(seconds, 1e-9)}


if __name__ == "__main__":
    main()
