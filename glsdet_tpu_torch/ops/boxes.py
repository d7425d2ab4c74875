"""Box geometry, the counterparts of ``glsdet_tpu.ops.boxes`` (xyxy
boxes unless a name says otherwise; ``cxcywh`` = centre and size,
``xywh`` = COCO corner and size).

The IoU is written as the same float expression as the JAX package
(clamp, then multiply; ``union = a1 + a2 - inter``; ``inter /
max(union, EPS)``): the CUDA NMS kernel repeats it operation for
operation, so keep the three in step.
"""

from __future__ import annotations

import torch

EPS = 1e-7


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5, cy + h * 0.5], dim=-1)


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5,
                        x2 - x1, y2 - y1], dim=-1)


def box_xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, w, h = boxes.unbind(-1)
    return torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)


def box_xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def bbox_area(boxes: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    """Area of xyxy boxes, clamped at zero; ``offset=1`` is the legacy
    +1 pixel-area convention."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0] + offset, min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1] + offset, min=0.0)
    return w * h


def _pairwise_intersection(boxes1, boxes2, offset: float = 0.0):
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = torch.clamp(rb - lt + offset, min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1, boxes2, offset: float = 0.0) -> torch.Tensor:
    """IoU matrix (..., N, M)."""
    inter = _pairwise_intersection(boxes1, boxes2, offset)
    area1 = bbox_area(boxes1, offset)
    area2 = bbox_area(boxes2, offset)
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / torch.clamp(union, min=EPS)


def pairwise_iof_min(boxes1, boxes2, offset: float = 0.0) -> torch.Tensor:
    """Intersection over the smaller box, inter / min(area1, area2): the
    reference eval driver's ``compute_iof`` gate."""
    inter = _pairwise_intersection(boxes1, boxes2, offset)
    area1 = bbox_area(boxes1, offset)
    area2 = bbox_area(boxes2, offset)
    denom = torch.minimum(area1[..., :, None], area2[..., None, :])
    return inter / torch.clamp(denom, min=EPS)


def pairwise_iof(boxes1, boxes2, offset: float = 0.0) -> torch.Tensor:
    """Intersection over the first box's area (mmdet's ``iof``), (..., N, M)."""
    inter = _pairwise_intersection(boxes1, boxes2, offset)
    area1 = bbox_area(boxes1, offset)
    return inter / torch.clamp(area1[..., :, None], min=EPS)


def _aligned_intersection(boxes1, boxes2, offset: float = 0.0):
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:4], boxes2[..., 2:4])
    wh = torch.clamp(rb - lt + offset, min=0.0)
    return wh[..., 0] * wh[..., 1]


def iou(boxes1, boxes2, offset: float = 0.0) -> torch.Tensor:
    """Aligned (elementwise) IoU between equal-shaped box sets."""
    inter = _aligned_intersection(boxes1, boxes2, offset)
    union = bbox_area(boxes1, offset) + bbox_area(boxes2, offset) - inter
    return inter / torch.clamp(union, min=EPS)


def iof(boxes1, boxes2, offset: float = 0.0) -> torch.Tensor:
    """Aligned intersection over the first box's area."""
    inter = _aligned_intersection(boxes1, boxes2, offset)
    return inter / torch.clamp(bbox_area(boxes1, offset), min=EPS)


def giou(boxes1, boxes2) -> torch.Tensor:
    """Aligned generalized IoU (the GFL box loss's)."""
    ious = iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:4], boxes2[..., 2:4])
    wh = torch.clamp(rb - lt, min=0.0)
    enclose = wh[..., 0] * wh[..., 1]
    inter = _aligned_intersection(boxes1, boxes2)
    union = bbox_area(boxes1) + bbox_area(boxes2) - inter
    return ious - (enclose - union) / torch.clamp(enclose, min=EPS)


def bbox_overlaps(boxes1, boxes2, mode: str = "iou",
                  is_aligned: bool = False, offset: float = 0.0
                  ) -> torch.Tensor:
    """mmdet-style dispatcher over the four overlap functions."""
    if is_aligned:
        fn = {"iou": iou, "iof": iof}[mode]
    else:
        fn = {"iou": pairwise_iou, "iof": pairwise_iof}[mode]
    return fn(boxes1, boxes2, offset=offset)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip xyxy boxes into [0, width] x [0, height]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, width), y1.clamp(0, height),
                        x2.clamp(0, width), y2.clamp(0, height)], dim=-1)


def scale_boxes_about_center(boxes: torch.Tensor, scale: float,
                             image_shape) -> torch.Tensor:
    """Expand xyxy boxes about their centres and clip to ``[0, dim - 1]``;
    ``image_shape`` is (width, height), as the reference UFP's
    ``scale_boxes``."""
    w, h = image_shape[0], image_shape[1]
    cx = (boxes[..., 2] + boxes[..., 0]) * 0.5
    cy = (boxes[..., 3] + boxes[..., 1]) * 0.5
    half_w = (boxes[..., 2] - boxes[..., 0]) * 0.5 * scale
    half_h = (boxes[..., 3] - boxes[..., 1]) * 0.5 * scale
    return torch.stack([(cx - half_w).clamp(0, w - 1),
                        (cy - half_h).clamp(0, h - 1),
                        (cx + half_w).clamp(0, w - 1),
                        (cy + half_h).clamp(0, h - 1)], dim=-1)
