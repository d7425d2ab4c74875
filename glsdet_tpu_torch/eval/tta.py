"""Test-time augmentation: multi-scale + flip aggregation, the counterpart
of ``glsdet_tpu.eval.tta``.

Behavioral reference: ``mmdet/datasets/pipelines/test_time_aug.py:11``
(MultiScaleFlipAug) + the aug_test merge: run the detector at several
scales and horizontal flip, map detections back to original coordinates,
concatenate, and NMS once.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from glsdet_tpu_torch.models.build import resolve_device
from glsdet_tpu_torch.ops.image import resize_linear_u8
from glsdet_tpu_torch.ops.nms import batched_nms


def tta_detect(
    detect_fn: Callable[[np.ndarray], dict],
    image: np.ndarray,
    scales: Sequence[float] = (1.0,),
    flip: bool = True,
    iou_thr: float = 0.65,
    max_dets: int = 300,
    device="cuda",
) -> dict:
    """Aggregate detections over scales x flips.

    detect_fn(image) -> dict(boxes xyxy in image coords, scores, labels),
    numpy; e.g. ``apis.Detector.detect`` (which resizes on its own, so a
    TTA "scale" rescales the input before the call).  A scale resizes the
    frame as ``cv2.resize(image, (int(w0 * s), int(h0 * s)))`` does
    (``ops/image.py: resize_linear_u8``, bit-equal, on ``device``); the union
    goes through one class-wise NMS on ``device`` (the NMS kernel on the
    card), then the top ``max_dets`` by score, ties by the lower row.
    """
    dev = resolve_device(device)
    h0, w0 = image.shape[:2]
    all_boxes, all_scores, all_labels = [], [], []
    for s in scales:
        img_s = (resize_linear_u8(
            torch.from_numpy(np.ascontiguousarray(image, np.uint8)).to(dev),
            (int(h0 * s), int(w0 * s))).cpu().numpy()
            if s != 1.0 else image)
        variants = [(img_s, False)]
        if flip:
            variants.append((img_s[:, ::-1].copy(), True))
        for img_v, flipped in variants:
            d = detect_fn(img_v)
            boxes = d["boxes"].copy()
            if flipped:
                wv = img_v.shape[1]
                boxes[:, [0, 2]] = wv - boxes[:, [2, 0]]
            boxes /= s
            all_boxes.append(boxes)
            all_scores.append(d["scores"])
            all_labels.append(d["labels"])

    boxes = np.concatenate(all_boxes).astype(np.float32)
    scores = np.concatenate(all_scores).astype(np.float32)
    labels = np.concatenate(all_labels).astype(np.int32)
    if len(boxes) == 0:
        return {"boxes": boxes, "scores": scores, "labels": labels}

    # one class-wise NMS over the union, as a batch of one
    keep, _ = batched_nms(torch.from_numpy(boxes)[None].to(dev),
                          torch.from_numpy(scores)[None].to(dev),
                          torch.from_numpy(labels)[None].to(dev), iou_thr)
    keep = keep[0].cpu().numpy()
    order = np.argsort(-scores[keep], kind="stable")[:max_dets]
    return {
        "boxes": boxes[keep][order],
        "scores": scores[keep][order],
        "labels": labels[keep][order],
    }
