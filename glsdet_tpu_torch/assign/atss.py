"""ATSS label assignment over padded GTs, the counterpart of
``glsdet_tpu.assign.atss`` (reference: mmdet's ``ATSSAssigner``,
topk=9).  Per GT:

1. the ``topk`` anchors closest (centre distance) to the GT centre on
   each pyramid level are candidates;
2. the IoU threshold is the mean + the unbiased std of the candidates'
   IoUs;
3. positives are candidates at or above it whose centre lies inside the
   GT (margin 0.01);
4. an anchor claimed by several GTs goes to the one of highest IoU.

Fixed shapes throughout (GTs padded to G with a validity mask), so the
assignment runs on the card without a host sync.  Leading batch
dimensions broadcast: one call assigns every image of a batch.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from glsdet_tpu_torch.ops.boxes import pairwise_iou
from glsdet_tpu_torch.ops.topk import topk_small_k

INF = 1e8


class AssignResult(NamedTuple):
    """Assignment over A anchors (leading batch dimensions as the GTs')."""

    assigned_gt: torch.Tensor  # (..., A) int64 index into the GTs, -1 = bg
    labels: torch.Tensor       # (..., A) int64 class id, num_classes = bg
    max_iou: torch.Tensor      # (..., A) IoU with the assigned GT (0 bg)


def atss_assign(anchors: torch.Tensor, num_level_anchors: Sequence[int],
                gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                gt_valid: torch.Tensor, num_classes: int,
                topk: int = 9) -> AssignResult:
    """Assign anchors (A, 4) xyxy to padded GTs: ``gt_boxes`` (..., G, 4),
    ``gt_labels`` (..., G), ``gt_valid`` (..., G) bool;
    ``num_level_anchors`` are the per-level counts summing to A."""
    iou_mat = pairwise_iou(gt_boxes, anchors)                 # (..., G, A)
    iou_mat = torch.where(gt_valid[..., None], iou_mat, 0.0)

    gt_cxy = (gt_boxes[..., :2] + gt_boxes[..., 2:4]) / 2.0
    an_cxy = (anchors[:, :2] + anchors[:, 2:4]) / 2.0
    diff = gt_cxy[..., :, None, :] - an_cxy
    dist = torch.sqrt((diff * diff).sum(-1))                  # (..., G, A)

    # per-level top-k closest anchors -> candidate mask
    levels, start = [], 0
    for n in num_level_anchors:
        _, idx = topk_small_k(-dist[..., start:start + n], min(topk, n))
        mask = torch.zeros(dist.shape[:-1] + (n,), dtype=torch.bool,
                           device=dist.device)
        levels.append(mask.scatter_(-1, idx, True))
        start += n
    cand = torch.cat(levels, dim=-1)

    # adaptive threshold; the reference's torch ``.std`` is the unbiased
    # estimator, so the masked variance divides by n - 1
    cand_f = cand.to(iou_mat.dtype)
    n_cand = cand_f.sum(-1).clamp(min=1.0)
    mean = (iou_mat * cand_f).sum(-1) / n_cand
    var = (((iou_mat - mean[..., None]) ** 2 * cand_f).sum(-1)
           / (n_cand - 1.0).clamp(min=1.0))
    thr = mean + torch.sqrt(var)                              # (..., G)

    # anchor centre inside the GT, margin 0.01
    l = an_cxy[:, 0] - gt_boxes[..., :, None, 0]
    t = an_cxy[:, 1] - gt_boxes[..., :, None, 1]
    r = gt_boxes[..., :, None, 2] - an_cxy[:, 0]
    b = gt_boxes[..., :, None, 3] - an_cxy[:, 1]
    inside = torch.minimum(torch.minimum(l, t), torch.minimum(r, b)) > 0.01

    is_pos = (cand & (iou_mat >= thr[..., None]) & inside
              & gt_valid[..., None])

    # conflicts: each anchor to its highest-IoU claiming GT (first on ties)
    claimed = torch.where(is_pos, iou_mat, -INF)
    best_iou = claimed.amax(dim=-2)                           # (..., A)
    best_gt = torch.argmax(claimed, dim=-2)
    fg = best_iou > -INF / 2
    assigned_gt = torch.where(fg, best_gt, -1)
    labels = torch.where(fg, torch.gather(gt_labels.long(), -1, best_gt),
                         num_classes)
    max_iou = torch.where(
        fg, torch.gather(iou_mat, -2, best_gt[..., None, :])[..., 0, :], 0.0)
    return AssignResult(assigned_gt, labels, max_iou)
