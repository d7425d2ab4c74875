"""SimOTA dynamic-k label assignment over padded GTs, the counterpart of
``glsdet_tpu.assign.sim_ota`` (reference: mmdet's ``SimOTAAssigner``
and yolox-drone's ``get_assignments``):

- candidates: prior centres strictly inside a GT box OR strictly inside
  the ``center_radius``-strides centre region of a GT;
- cost = BCE(sqrt(cls * obj), onehot) + 3 * (-log IoU)
  + INF * not(in-box AND in-centre) + INF * not(a candidate);
- dynamic k per GT = clip(int(sum of its top-10 candidate IoUs), 1, 10);
- each GT takes its k lowest-cost anchors (a masked fixed top-k: ranks
  below k whose cost is finite); an anchor claimed by several GTs goes to
  the GT of least cost (the first on ties).

One call assigns a whole batch: every tensor carries a leading batch
dimension and the shapes are fixed, so nothing is read back to the host
(no ``F.one_hot``, no boolean indexing, no ``nonzero``).  The class term
takes one pass over (B, G, A): ``t`` is exactly one-hot, so the JAX
package's ``sum_c t * logp + (1 - t) * log1mp`` is ``sum_c log1mp`` plus
``logp - log1mp`` gathered at the GT's label, without its (B, G, A, C)
broadcast, which at coarse_det's training shapes is 806 MB a tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from glsdet_tpu_torch.ops.boxes import pairwise_iou
from glsdet_tpu_torch.ops.topk import topk_small_k

INF = 100000.0
EPS = 1e-8


class OTAResult(NamedTuple):
    fg_mask: torch.Tensor      # (B, A) bool
    matched_gt: torch.Tensor   # (B, A) int64, -1 for background
    matched_iou: torch.Tensor  # (B, A) IoU with the matched GT (0 bg)


def _prob_logs(p: torch.Tensor):
    """log p and log(1 - p), each clamped at -100 as torch's
    ``binary_cross_entropy`` kernel does; ``p < 1`` guards the log1p."""
    logp = torch.clamp(torch.log(p), min=-100.0)
    below = p < 1.0
    log1mp = torch.where(
        below, torch.clamp(torch.log1p(-torch.where(below, p, 0.0)),
                           min=-100.0), -100.0)
    return logp, log1mp


def in_regions(priors_cxy: torch.Tensor, priors_stride: torch.Tensor,
               gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
               center_radius: float = 2.5):
    """(in_box, in_center), each (B, G, A): the prior centre strictly
    inside the GT box, and strictly inside its ``center_radius``-strides
    centre region; invalid GTs masked out."""
    x = priors_cxy[:, 0]
    y = priors_cxy[:, 1]
    bx = gt_boxes[..., None, :]                       # (B, G, 1, 4)
    in_box = ((x > bx[..., 0]) & (x < bx[..., 2])
              & (y > bx[..., 1]) & (y < bx[..., 3]))
    cx = ((gt_boxes[..., 0] + gt_boxes[..., 2]) / 2.0)[..., None]
    cy = ((gt_boxes[..., 1] + gt_boxes[..., 3]) / 2.0)[..., None]
    rad = center_radius * priors_stride
    in_center = ((x > cx - rad) & (x < cx + rad)
                 & (y > cy - rad) & (y < cy + rad))
    valid = gt_valid[..., None]
    return in_box & valid, in_center & valid


def sim_ota_assign(priors_cxy: torch.Tensor, priors_stride: torch.Tensor,
                   decoded_boxes: torch.Tensor, cls_probs: torch.Tensor,
                   obj_probs: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   center_radius: float = 2.5, candidate_topk: int = 10,
                   cls_cost_weight: float = 1.0,
                   iou_cost_weight: float = 3.0) -> OTAResult:
    """Fixed-shape batched SimOTA.

    Args:
        priors_cxy: (A, 2) prior centres in image coordinates.
        priors_stride: (A,).
        decoded_boxes: (B, A, 4) xyxy predictions.
        cls_probs: (B, A, C) class probabilities (the no-sigmoid loss
            ablations pass raw head outputs; the clip keeps the sqrt and
            the logs in their domain).
        obj_probs: (B, A) objectness.
        gt_boxes: (B, G, 4) padded xyxy; gt_labels: (B, G) int;
        gt_valid: (B, G) bool.
        cls_cost_weight, iou_cost_weight: cls + 3 * iou by default; the
            decoupled loss's cls half uses 3 * cls + 1 * iou.
    Callers pass detached probabilities: the assignment is a target.
    """
    num_classes = cls_probs.shape[-1]
    n_anchors = cls_probs.shape[1]
    in_box, in_center = in_regions(priors_cxy, priors_stride, gt_boxes,
                                   gt_valid, center_radius)
    is_cand = in_box.any(dim=1) | in_center.any(dim=1)       # (B, A)
    in_both = in_box & in_center                             # (B, G, A)

    iou_mat = pairwise_iou(gt_boxes, decoded_boxes)          # (B, G, A)
    iou_mat = torch.where(gt_valid[..., None], iou_mat, 0.0)
    iou_cost = -torch.log(iou_mat + EPS)

    joint = torch.sqrt(torch.clamp(cls_probs * obj_probs[..., None],
                                   EPS, 1.0))                # (B, A, C)
    logp, log1mp = _prob_logs(joint)
    # sum_c log1mp, plus logp - log1mp at the GT's label: a label outside
    # [0, C) picks the zero column, as an all-zero one-hot row would
    diff = torch.cat([logp - log1mp, torch.zeros_like(logp[..., :1])],
                     -1).transpose(1, 2)                     # (B, C + 1, A)
    in_range = (gt_labels >= 0) & (gt_labels < num_classes)
    label = torch.where(in_range, gt_labels, num_classes).long()
    at_label = torch.gather(diff, 1, label[..., None].expand(
        -1, -1, n_anchors))                                  # (B, G, A)
    cls_cost = -(log1mp.sum(-1)[:, None, :] + at_label)      # (B, G, A)

    cost = (cls_cost_weight * cls_cost + iou_cost_weight * iou_cost
            + INF * (~in_both).to(cls_cost.dtype)
            + INF * (~is_cand[:, None, :]).to(cls_cost.dtype))

    k = min(candidate_topk, n_anchors)
    cand_iou = torch.where(is_cand[:, None, :], iou_mat, 0.0)
    topk_ious, _ = topk_small_k(cand_iou, k)
    dynamic_k = torch.clamp(topk_ious.sum(-1).to(torch.int32), 1,
                            candidate_topk)                  # (B, G)

    neg_cost, idx = topk_small_k(-cost, k)                   # (B, G, k)
    ranks = torch.arange(k, device=cost.device)
    keep = (ranks < dynamic_k[..., None]) & (neg_cost > -INF / 2)
    matching = torch.zeros_like(cost, dtype=torch.bool).scatter(
        -1, idx, keep)
    matching = matching & gt_valid[..., None]

    cost_masked = torch.where(matching, cost, INF * 2)
    best_gt = torch.argmin(cost_masked, dim=1)               # (B, A)
    fg = matching.any(dim=1)
    matched_gt = torch.where(fg, best_gt, -1)
    matched_iou = torch.where(
        fg, torch.gather(iou_mat, 1, best_gt[:, None, :])[:, 0], 0.0)
    return OTAResult(fg, matched_gt, matched_iou)
