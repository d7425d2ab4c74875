"""YOLOX training losses with SimOTA targets, the counterparts of
``glsdet_tpu.train.yolox_loss`` (references: mmdet's ``YOLOXHead.loss``
and yolox-drone's ``get_losses`` with its ablations):

    loss = 5 * IoU-loss(positives) / num_fg
         + BCE(obj, fg) / num_fg                 (over all anchors)
         + BCE(cls, onehot * matched IoU) / num_fg  (positives)
         [+ L1 on the raw box outputs in the last no-mosaic epochs]

``num_fg`` is the batch's positive count, floored at 1; in a process
group (``parallel/mesh.py``) it is the global batch's, summed over the
group before the floor, as the JAX package's global-view step counts it,
so each rank's loss is its share of the global batch's.  The assignment
runs on detached probabilities and its matched IoU is a constant target:
were it not, the cls-BCE gradient with respect to that target would flow
back through the decoded boxes and shrink them.

Every entry point takes (B, A, ...) head outputs in float32, the priors'
centres and strides, and padded (B, G, ...) GTs, and makes no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from glsdet_tpu_torch.assign.sim_ota import in_regions, sim_ota_assign
from glsdet_tpu_torch.losses import (_one_hot, bce_with_logits, giou_loss,
                                     iou_loss, l1_loss)
from glsdet_tpu_torch.models.yolox_head import decode_boxes
from glsdet_tpu_torch.parallel import mesh

VARIANTS = ("mmdet", "cls_sigmoid", "no_sigmoid")


class YOLOXLossOut(NamedTuple):
    total: torch.Tensor
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    loss_obj: torch.Tensor
    loss_l1: torch.Tensor
    num_fg: torch.Tensor


def _bce_probs(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """BCE on probabilities (``nn.BCELoss`` of the no-sigmoid ablations):
    torch's kernel on (0, 1), log clamp at -100 included.  Inputs are
    clipped to [0, 1] and both logs are guarded by an inner ``where``, so
    values and gradients stay finite at the clamps (a bare log of the
    clipped value backpropagates inf * 0 = NaN through ``torch.where``)."""
    p = torch.clamp(p, 0.0, 1.0)
    pos, below = p > 0, p < 1
    logp = torch.where(
        pos, torch.clamp(torch.log(torch.where(pos, p, 1.0)), min=-100.0),
        -100.0)
    log1mp = torch.where(
        below, torch.clamp(torch.log1p(-torch.where(below, p, 0.0)),
                           min=-100.0), -100.0)
    return -(t * logp + (1.0 - t) * log1mp)


def _grids(priors_cxy, priors_stride):
    return priors_cxy / priors_stride[:, None] - 0.5


def _assign(decoded, cls_p, obj_p, priors_cxy, priors_stride, gt_boxes,
            gt_labels, gt_valid, **kw):
    """SimOTA on detached probabilities; the matched IoU is detached too."""
    fg, matched_gt, matched_iou = sim_ota_assign(
        priors_cxy, priors_stride, decoded.detach(), cls_p.detach(),
        obj_p.detach(), gt_boxes, gt_labels, gt_valid, **kw)
    return fg, matched_gt, matched_iou.detach()


def _num_fg(fg: torch.Tensor) -> torch.Tensor:
    """The (global) batch's positive count, floored at 1 after the sum
    over the process group."""
    return torch.clamp(mesh.all_sum(fg.float().sum()), min=1.0)


def _targets(matched_gt, gt_boxes, gt_labels):
    """Per anchor, the matched GT's box (B, A, 4) and label (B, A)."""
    safe = torch.clamp(matched_gt, min=0)
    boxes = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1, 4))
    labels = torch.gather(gt_labels, 1, safe)
    return boxes, labels


def yolox_loss(cls_logits: torch.Tensor, reg_raw: torch.Tensor,
               obj_logits: torch.Tensor, priors_cxy: torch.Tensor,
               priors_stride: torch.Tensor, gt_boxes: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor,
               use_l1: bool = False, cls_loss_type: str = "bce",
               variant: str = "mmdet", bbox_loss_mode: str = "square"
               ) -> YOLOXLossOut:
    """cls_logits (B, A, C), reg_raw (B, A, 4) before the decode,
    obj_logits (B, A); priors_cxy (A, 2) centres (offset 0.5, image
    coordinates), priors_stride (A,); GTs (B, G, ...) with ``gt_valid``.

    ``variant``: ``mmdet`` (sigmoid(cls) * sigmoid(obj) in the cost,
    BCE-with-logits losses), ``cls_sigmoid`` (sigmoid on cls only in the
    cost; the obj loss is BCE on the raw output as a probability) or
    ``no_sigmoid`` (raw outputs in the cost, probability BCE for obj and
    cls).  ``cls_loss_type``: ``bce`` or ``focal`` (alpha 0.25, gamma
    2, against plain one-hot targets).  ``bbox_loss_mode``: ``square``
    (1 - IoU^2), ``linear``, ``log`` or ``giou``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown yolox loss variant: {variant!r}")
    num_classes = cls_logits.shape[-1]
    grids = _grids(priors_cxy, priors_stride)
    decoded = decode_boxes(reg_raw, grids, priors_stride)    # (B, A, 4)

    cls_p = cls_logits if variant == "no_sigmoid" else torch.sigmoid(
        cls_logits)
    obj_p = obj_logits if variant != "mmdet" else torch.sigmoid(obj_logits)
    fg, matched_gt, matched_iou = _assign(
        decoded, cls_p, obj_p, priors_cxy, priors_stride, gt_boxes,
        gt_labels, gt_valid)
    num_fg = _num_fg(fg)
    tgt_boxes, tgt_labels = _targets(matched_gt, gt_boxes, gt_labels)
    fg_f = fg.float()

    if bbox_loss_mode == "giou":
        lb = giou_loss(decoded.reshape(-1, 4), tgt_boxes.reshape(-1, 4))
    else:
        lb = iou_loss(decoded.reshape(-1, 4), tgt_boxes.reshape(-1, 4),
                      mode=bbox_loss_mode)
    loss_bbox = 5.0 * (lb * fg_f.reshape(-1)).sum() / num_fg

    if variant == "mmdet":
        loss_obj = bce_with_logits(obj_logits, fg_f).sum() / num_fg
    else:
        loss_obj = _bce_probs(obj_logits, fg_f).sum() / num_fg

    onehot = _one_hot(tgt_labels, num_classes, cls_logits.dtype)
    if cls_loss_type == "focal":
        p = torch.sigmoid(cls_logits)
        ce = bce_with_logits(cls_logits, onehot)
        p_t = p * onehot + (1 - p) * (1 - onehot)
        a_t = 0.25 * onehot + 0.75 * (1 - onehot)
        lc = (a_t * (1 - p_t) ** 2 * ce).sum(-1)
    elif variant == "no_sigmoid":
        lc = _bce_probs(cls_logits, onehot * matched_iou[..., None]).sum(-1)
    else:
        lc = bce_with_logits(cls_logits,
                             onehot * matched_iou[..., None]).sum(-1)
    loss_cls = (lc * fg_f).sum() / num_fg

    if use_l1:
        cxy = (tgt_boxes[..., :2] + tgt_boxes[..., 2:4]) / 2.0
        wh = torch.clamp(tgt_boxes[..., 2:4] - tgt_boxes[..., :2],
                         min=1e-8)
        stride = priors_stride[None, :, None]
        tgt_raw = torch.cat([cxy / stride - grids[None],
                             torch.log(wh / stride)], dim=-1)
        ll1 = l1_loss(reg_raw, tgt_raw).sum(-1)
        loss_l1 = (ll1 * fg_f).sum() / num_fg
    else:
        loss_l1 = torch.zeros((), device=cls_logits.device)

    total = loss_cls + loss_bbox + loss_obj + loss_l1
    return YOLOXLossOut(total, loss_cls, loss_bbox, loss_obj, loss_l1,
                        num_fg)


def _weighted(weights, outs):
    return sum(w * o for w, o in zip(weights, outs))


def _minmax_weights(c: torch.Tensor, dim: int) -> torch.Tensor:
    """``2 - (c - min) / (max - min)`` along ``dim``, 2 where all tie
    (``generate_weights``)."""
    mx = c.amax(dim, keepdim=True)
    mn = c.amin(dim, keepdim=True)
    spread = mx - mn
    return torch.where(spread > 0,
                       2.0 - (c - mn) / torch.where(spread > 0, spread, 1.0),
                       torch.full_like(c, 2.0))


def yolox_loss_3assign(cls_logits, reg_raw, obj_logits, priors_cxy,
                       priors_stride, level_counts: Sequence[int],
                       gt_boxes, gt_labels, gt_valid) -> YOLOXLossOut:
    """Per-level assignment ("3-assign", yolox-drone yolox_3assign.py):
    each pyramid level runs its own SimOTA and loss; the level losses
    are combined with weights ``2 - (n - min) / (max - min)`` of their
    positive counts, normalised by their sum.  ``level_counts``: the
    static anchor count of each level."""
    outs, start = [], 0
    for n in level_counts:
        sl = slice(start, start + n)
        outs.append(yolox_loss(
            cls_logits[:, sl], reg_raw[:, sl], obj_logits[:, sl],
            priors_cxy[sl], priors_stride[sl], gt_boxes, gt_labels,
            gt_valid))
        start += n
    counts = torch.stack([o.num_fg for o in outs])
    w = _minmax_weights(counts, 0)
    w = w / w.sum()
    fields = zip(*[o[:5] for o in outs])
    return YOLOXLossOut(*[_weighted(w, f) for f in fields], counts.sum())


def _level_weights(fg: torch.Tensor, level_counts: Sequence[int],
                   mode: str = "minmax") -> torch.Tensor:
    """Per image and pyramid level, a weight from the level's positive
    count ``n``, broadcast over the level's anchors -> (B, A).

    ``minmax`` (yolox_losses_decoupled.py, the fpn_weight family):
    ``2 - (n - min) / (max - min)`` (2 where the levels tie); ``softmax``
    (yolox_losses_fpn_weight_sigmoid640v2.py): ``1.5 - softmax(n /
    sum(n))`` (all ones where the image has no positive)."""
    c = torch.stack([part.float().sum(1) for part in
                     torch.split(fg, list(level_counts), dim=1)], 1)
    if mode == "softmax":
        total = c.sum(1, keepdim=True)
        frac = c / torch.clamp(total, min=1.0)
        w = torch.where(total > 0, 1.5 - torch.softmax(frac, dim=1),
                        torch.ones_like(c))
    else:
        w = _minmax_weights(c, 1)
    return torch.cat([w[:, k:k + 1].expand(-1, n)
                      for k, n in enumerate(level_counts)], dim=1)


def _candidate_mask(priors_cxy, priors_stride, gt_boxes, gt_valid,
                    center_radius: float = 2.5) -> torch.Tensor:
    """(B, A) SimOTA candidates before matching: the prior centre inside
    any valid GT box or its centre region, the dw loss's ``is_in_box``
    snapshot (yolox_losses_dw_sigmoid640.py)."""
    in_box, in_center = in_regions(priors_cxy, priors_stride, gt_boxes,
                                   gt_valid, center_radius)
    return (in_box | in_center).any(dim=1)


def yolox_loss_fpn_weight(cls_logits, reg_raw, obj_logits, priors_cxy,
                          priors_stride, level_counts: Sequence[int],
                          gt_boxes, gt_labels, gt_valid,
                          sigmoid: bool = True, weight_mode: str = "minmax",
                          neg_cls_terms: bool = False) -> YOLOXLossOut:
    """The FPN-level-reweighted family (yolox-drone models/losses):

    - ``sigmoid=False`` (yolox_losses_fpn_weight.py): one assignment on
      raw head outputs, each image's levels weighted by their positive
      counts, probability BCE;
    - ``sigmoid=True`` (..._fpn_weight_sigmoid.py): sigmoid in the cost,
      BCE-with-logits losses;
    - ``weight_mode="softmax"`` (..._sigmoid640v2.py);
    - ``neg_cls_terms=True`` (yolox_losses_dw_sigmoid640.py): weights 1,
      plus two negative cls terms: the reference's focal term against
      zero targets on anchors outside every candidate region (its ``pt``
      is the raw logit: 0.75 * x^2 * BCE), and BCE-with-logits of the
      logits against themselves on in-region negatives (both kept as the
      reference writes them)."""
    num_classes = cls_logits.shape[-1]
    grids = _grids(priors_cxy, priors_stride)
    decoded = decode_boxes(reg_raw, grids, priors_stride)
    cls_p = torch.sigmoid(cls_logits) if sigmoid else cls_logits
    obj_p = torch.sigmoid(obj_logits) if sigmoid else obj_logits
    fg, matched_gt, matched_iou = _assign(
        decoded, cls_p, obj_p, priors_cxy, priors_stride, gt_boxes,
        gt_labels, gt_valid)
    num_fg = _num_fg(fg)
    tgt_boxes, tgt_labels = _targets(matched_gt, gt_boxes, gt_labels)
    cls_tgt = _one_hot(tgt_labels, num_classes, cls_logits.dtype) \
        * matched_iou[..., None]
    fg_f = fg.float()
    w = (torch.ones_like(fg_f) if neg_cls_terms
         else _level_weights(fg, level_counts, mode=weight_mode))

    bce = bce_with_logits if sigmoid else _bce_probs
    lb = iou_loss(decoded.reshape(-1, 4), tgt_boxes.reshape(-1, 4))
    loss_bbox = 5.0 * (lb * (fg_f * w).reshape(-1)).sum() / num_fg
    loss_obj = (bce(obj_logits, fg_f) * w).sum() / num_fg
    lc = bce(cls_logits, cls_tgt).sum(-1)
    loss_cls = (lc * fg_f * w).sum() / num_fg
    total = loss_cls + loss_bbox + loss_obj
    if neg_cls_terms:
        cand = _candidate_mask(priors_cxy, priors_stride, gt_boxes,
                               gt_valid)
        outside = (~fg & ~cand).float()
        inside_neg = (~fg & cand).float()
        ce0 = bce_with_logits(cls_logits, torch.zeros_like(cls_logits))
        focal0 = (0.75 * cls_logits ** 2 * ce0).sum(-1)
        self_bce = bce_with_logits(cls_logits, cls_logits).sum(-1)
        total = (total + (focal0 * outside).sum() / num_fg
                 + (self_bce * inside_neg).sum() / num_fg)
    return YOLOXLossOut(total, loss_cls, loss_bbox, loss_obj,
                        torch.zeros((), device=cls_logits.device), num_fg)


def yolox_loss_decoupled(cls_logits, reg_raw, obj_logits, priors_cxy,
                         priors_stride, level_counts: Sequence[int],
                         gt_boxes, gt_labels, gt_valid) -> YOLOXLossOut:
    """The decoupled cls/reg ablation (yolox_losses_decoupled.py): a cls
    half and a reg half, each with its own SimOTA on raw head outputs
    (cost weights 3 * cls + 1 * iou and cls + 3 * iou), level weights
    from its own positives, probability BCE, and its own num_fg."""
    num_classes = cls_logits.shape[-1]
    grids = _grids(priors_cxy, priors_stride)
    decoded = decode_boxes(reg_raw, grids, priors_stride)

    def assign(cls_w, iou_w):
        return _assign(decoded, cls_logits, obj_logits, priors_cxy,
                       priors_stride, gt_boxes, gt_labels, gt_valid,
                       cls_cost_weight=cls_w, iou_cost_weight=iou_w)

    fg_c, matched_gt_c, matched_iou_c = assign(3.0, 1.0)
    num_fg_c = _num_fg(fg_c)
    _, tgt_labels_c = _targets(matched_gt_c, gt_boxes, gt_labels)
    cls_tgt = _one_hot(tgt_labels_c, num_classes, cls_logits.dtype) \
        * matched_iou_c[..., None]
    w_cls = _level_weights(fg_c, level_counts)
    lc = _bce_probs(cls_logits, cls_tgt).sum(-1)
    loss_cls = (lc * fg_c.float() * w_cls).sum() / num_fg_c

    fg_r, matched_gt_r, _ = assign(1.0, 3.0)
    num_fg_r = _num_fg(fg_r)
    tgt_boxes_r, _ = _targets(matched_gt_r, gt_boxes, gt_labels)
    w_reg = _level_weights(fg_r, level_counts)
    fg_rf = fg_r.float()
    lb = iou_loss(decoded.reshape(-1, 4), tgt_boxes_r.reshape(-1, 4))
    loss_bbox = 5.0 * (lb * (fg_rf * w_reg).reshape(-1)).sum() / num_fg_r
    loss_obj = (_bce_probs(obj_logits, fg_rf) * w_reg).sum() / num_fg_r
    total = loss_cls + loss_bbox + loss_obj
    return YOLOXLossOut(total, loss_cls, loss_bbox, loss_obj,
                        torch.zeros((), device=cls_logits.device), num_fg_r)
