"""Result-level global-local fusion, the counterpart of
``glsdet_tpu.eval.fusion``.

The full-image ("global") and UFP-mosaic ("local") detection sets of an
image are concatenated and put through one class-wise NMS at IoU 0.65
(``yolox-drone/merge_results.py:153-158``), or through gaussian soft-NMS
(``:41``, ``:121``), then ranked to a fixed ``max_dets`` rows.  The hard
branch is the port's ``batched_nms``: kernel B2 on the card.
"""

from __future__ import annotations

import torch

from glsdet_tpu_torch.ops.nms import (NEG_INF, batched_nms, soft_nms,
                                      topk_stable)


def fuse_detections_batch(dets_a: dict, dets_b: dict, iou_thr: float = 0.65,
                          max_dets: int = 500, use_soft: bool = False,
                          sigma: float = 0.5) -> dict:
    """Fuse two batched detection dicts (boxes (B, K, 4), scores, labels,
    valid (B, K)); returns the same structure with ``max_dets`` rows per
    image, ranked by score (ties by the lower row, global rows first)."""
    boxes = torch.cat([dets_a["boxes"], dets_b["boxes"]], dim=1)
    scores = torch.cat([dets_a["scores"], dets_b["scores"]], dim=1)
    labels = torch.cat([dets_a["labels"], dets_b["labels"]], dim=1)
    valid = torch.cat([dets_a["valid"], dets_b["valid"]], dim=1)
    scores = torch.where(valid, scores, NEG_INF)

    if use_soft:
        offsets = labels.to(boxes.dtype)[..., None] * 8192.0
        kept = torch.stack([soft_nms(b, s, sigma=sigma)
                            for b, s in zip(boxes + offsets, scores)])
    else:
        keep, _ = batched_nms(boxes, scores, labels, iou_thr)
        kept = torch.where(keep, scores, NEG_INF)

    out_scores, idx = topk_stable(kept, max_dets)
    out_valid = out_scores > NEG_INF / 2
    return {
        "boxes": torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        "scores": torch.where(out_valid, out_scores, 0.0),
        "labels": torch.gather(labels, 1, idx),
        "valid": out_valid,
    }


def fuse_detections(dets_a: dict, dets_b: dict, iou_thr: float = 0.65,
                    max_dets: int = 500, use_soft: bool = False,
                    sigma: float = 0.5) -> dict:
    """One image's detection dicts (boxes (K, 4), scores, labels, valid
    (K,)): :func:`fuse_detections_batch` over a batch of one."""
    out = fuse_detections_batch(
        {k: v[None] for k, v in dets_a.items()},
        {k: v[None] for k, v in dets_b.items()},
        iou_thr, max_dets, use_soft, sigma)
    return {k: v[0] for k, v in out.items()}
