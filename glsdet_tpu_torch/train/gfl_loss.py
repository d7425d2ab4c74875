"""GFL training loss (QFL + DFL + GIoU on ATSS targets), the counterpart
of ``glsdet_tpu.train.gfl_loss``: all pyramid levels flattened into one
(B, A, ...) tensor, per-level sums folded into global sums (reference:
mmdet ``gfl_head.py`` ``get_targets`` / ``loss_single`` / ``loss``).
In a process group (``parallel/mesh.py``) the positive count and the
quality-weight normaliser are the global batch's, so each rank's loss is
its share of the global batch's."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from glsdet_tpu_torch.assign.atss import atss_assign
from glsdet_tpu_torch.losses import (distribution_focal_loss, giou_loss,
                                     quality_focal_loss)
from glsdet_tpu_torch.ops.boxes import iou as aligned_iou
from glsdet_tpu_torch.ops.integral import (bbox2distance, distance2bbox,
                                           integral_decode)
from glsdet_tpu_torch.parallel import mesh


class GFLTargets(NamedTuple):
    labels: torch.Tensor         # (B, A) int64; num_classes = bg
    bbox_targets: torch.Tensor   # (B, A, 4) xyxy image coordinates
    pos_mask: torch.Tensor       # (B, A) bool
    # mmdet's label_weights: 1 for every assigned anchor; ATSS has no
    # ignore path yet, so all ones
    label_weights: torch.Tensor  # (B, A) float32


def gfl_targets(anchors: torch.Tensor, num_level_anchors: Sequence[int],
                gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                gt_valid: torch.Tensor, num_classes: int,
                topk: int = 9) -> GFLTargets:
    """ATSS over the batch: GTs padded to (B, G)."""
    res = atss_assign(anchors, num_level_anchors, gt_boxes, gt_labels,
                      gt_valid, num_classes, topk=topk)
    pos = res.assigned_gt >= 0
    idx = res.assigned_gt.clamp(min=0)
    tgt = torch.gather(gt_boxes, 1, idx[..., None].expand(-1, -1, 4))
    tgt = torch.where(pos[..., None], tgt, 0.0)
    return GFLTargets(res.labels, tgt, pos,
                      torch.ones(res.labels.shape, dtype=torch.float32,
                                 device=res.labels.device))


class GFLLossOut(NamedTuple):
    total: torch.Tensor
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    loss_dfl: torch.Tensor
    num_total_samples: torch.Tensor  # positive count (>= 1)
    quality: torch.Tensor            # (B, A) IoU quality target


def gfl_loss(cls_scores: torch.Tensor, bbox_pred_logits: torch.Tensor,
             targets: GFLTargets, anchor_centers: torch.Tensor,
             anchor_strides: torch.Tensor, num_classes: int,
             reg_max: int = 16, loss_dfl_weight: float = 0.25,
             loss_bbox_weight: float = 2.0,
             avg_factor_floor: float = 1.0) -> GFLLossOut:
    """QFL + GIoU + DFL.  ``cls_scores`` (B, A, C) joint logits,
    ``bbox_pred_logits`` (B, A, 4 * (reg_max + 1)), ``anchor_centers``
    (A, 2), ``anchor_strides`` (A,).  ``avg_factor_floor`` floors the
    quality-weight normaliser: GFLHead clamps it at 1, MPHead divides by
    the raw sum (its callers pass a tiny floor that only guards 0/0)."""
    b, a, c = cls_scores.shape
    pos = targets.pos_mask
    # the reference counts max(pos_i, 1) per image: an image without
    # positives still adds 1 to the QFL normaliser
    num_pos = mesh.all_sum(pos.float().sum(1).clamp(min=1.0).sum())
    num_total_samples = num_pos.clamp(min=1.0)

    stride = anchor_strides[None, :, None]
    centers_s = anchor_centers[None, :, :] / stride          # stride units

    dists = integral_decode(bbox_pred_logits, reg_max)
    pred_boxes = distance2bbox(centers_s.expand(b, a, 2), dists)
    tgt_boxes = targets.bbox_targets / stride

    quality = torch.where(pos, aligned_iou(pred_boxes.detach(), tgt_boxes),
                          0.0)

    # quality weight: the detached max sigmoid score at positives
    weight = torch.sigmoid(cls_scores.detach()).amax(-1)
    weight = torch.where(pos, weight, 0.0)
    avg_factor = mesh.all_sum(weight.sum()).clamp(min=avg_factor_floor)

    lb = giou_loss(pred_boxes.reshape(-1, 4), tgt_boxes.reshape(-1, 4))
    loss_bbox = loss_bbox_weight * (lb * weight.reshape(-1)).sum() \
        / avg_factor

    tgt_dist = bbox2distance(centers_s, tgt_boxes, reg_max)
    dfl = distribution_focal_loss(bbox_pred_logits.reshape(-1, reg_max + 1),
                                  tgt_dist.reshape(-1))
    dfl_w = weight.reshape(-1, 1).expand(-1, 4).reshape(-1) / 4.0
    loss_dfl = loss_dfl_weight * (dfl * dfl_w).sum() / avg_factor

    qfl = quality_focal_loss(cls_scores.reshape(-1, c),
                             targets.labels.reshape(-1),
                             quality.reshape(-1), num_classes)
    loss_cls = (qfl * targets.label_weights.reshape(-1)).sum() \
        / num_total_samples

    total = loss_cls + loss_bbox + loss_dfl
    return GFLLossOut(total, loss_cls, loss_bbox, loss_dfl,
                      num_total_samples, quality)
