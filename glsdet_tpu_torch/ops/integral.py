"""GFL distribution-to-distance decoding, the counterpart of
``glsdet_tpu.ops.integral``."""

from __future__ import annotations

import torch


def integral_decode(logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """(..., 4*(reg_max+1)) distribution logits -> (..., 4) distances:
    the softmax expectation over {0..reg_max} for each box side."""
    x = logits.reshape(*logits.shape[:-1], 4, reg_max + 1)
    probs = torch.softmax(x, dim=-1)
    project = torch.arange(reg_max + 1, dtype=probs.dtype,
                           device=probs.device)
    return probs @ project


def distance2bbox(points: torch.Tensor, distances: torch.Tensor,
                  max_shape=None) -> torch.Tensor:
    """(l, t, r, b) distances from center points -> xyxy boxes, clipped
    to ``max_shape`` = (h, w) when given."""
    x1 = points[..., 0] - distances[..., 0]
    y1 = points[..., 1] - distances[..., 1]
    x2 = points[..., 0] + distances[..., 2]
    y2 = points[..., 1] + distances[..., 3]
    if max_shape is not None:
        h, w = max_shape
        x1, x2 = x1.clamp(0, w), x2.clamp(0, w)
        y1, y2 = y1.clamp(0, h), y2.clamp(0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox2distance(points: torch.Tensor, bboxes: torch.Tensor,
                  reg_max: float | None = None) -> torch.Tensor:
    """xyxy boxes -> (l, t, r, b) distances from ``points``, clamped to
    ``[0, reg_max - 0.1]`` when ``reg_max`` is given (the reference
    coder's encode)."""
    d = torch.stack([points[..., 0] - bboxes[..., 0],
                     points[..., 1] - bboxes[..., 1],
                     bboxes[..., 2] - points[..., 0],
                     bboxes[..., 3] - points[..., 1]], dim=-1)
    if reg_max is not None:
        d = d.clamp(0, reg_max - 0.1)
    return d
