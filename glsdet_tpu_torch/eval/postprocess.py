"""Test-time decode + NMS for both detector families, the counterparts of
``glsdet_tpu.eval.postprocess``.

Both take per-level NHWC head maps and return fixed-size ranked detection
sets ``dict(boxes (B,K,4), scores (B,K), labels (B,K), valid (B,K))``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from glsdet_tpu_torch.models.yolox_head import (decode_boxes,
                                                flatten_head_outputs)
from glsdet_tpu_torch.ops.image import unletterbox_boxes
from glsdet_tpu_torch.ops.integral import distance2bbox, integral_decode
from glsdet_tpu_torch.ops.nms import multiclass_nms_batched, topk_stable
from glsdet_tpu_torch.ops.priors import featmap_sizes, grid_points

_priors: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def _dets(ob, osc, ol, ov) -> dict:
    return {"boxes": ob, "scores": osc, "labels": ol, "valid": ov}


def _on_device(key: tuple, make: Callable[[], Tuple[np.ndarray, ...]],
               device) -> Tuple[torch.Tensor, ...]:
    """Host-built priors, copied to ``device`` once per (key, device) and
    kept: a decode then copies nothing to the card, a copy that would
    wait for it (the serving stages make no host sync).  They are made
    outside inference mode, so that a program exported after an
    inference-mode call (``tools/export.py``) can hold them."""
    k = (key, torch.device(device))
    if k not in _priors:
        with torch.inference_mode(False):
            _priors[k] = tuple(torch.from_numpy(a).to(device)
                               for a in make())
    return _priors[k]


def yolox_postprocess(cls_out: Sequence[torch.Tensor],
                      reg_out: Sequence[torch.Tensor],
                      obj_out: Sequence[torch.Tensor],
                      img_hw: Tuple[int, int],
                      strides: Sequence[int] = (8, 16, 32),
                      score_thr: float = 0.01, iou_thr: float = 0.65,
                      max_dets: int = 100, single_label: bool = True,
                      apply_sigmoid: str = "all") -> dict:
    """YOLOX decode: score = obj * cls, then class-wise NMS.

    ``single_label=True`` is the reference's semantics: each anchor keeps
    only its max-class entry, one candidate per anchor.  ``False`` is
    mmdet's multiclass decode: every above-threshold (anchor, class) pair
    competes.

    ``apply_sigmoid`` serves the loss-ablation heads whose decode bakes
    in (or leaves out) the activations: ``"all"`` (sigmoid on obj and
    cls, the default), ``"cls"`` (cls only, the ``cls_sigmoid`` loss
    variant), ``"obj"`` (obj only) or ``"none"`` (raw maps, the
    ``no_sigmoid`` variant)."""
    if apply_sigmoid not in ("all", "cls", "obj", "none"):
        raise ValueError(f"apply_sigmoid {apply_sigmoid!r}")
    def make():
        centers, strides_np, _ = grid_points(img_hw, strides, offset=0.5)
        return centers / strides_np[:, None] - 0.5, strides_np

    grids, stride_v = _on_device(("yolox", tuple(img_hw), tuple(strides)),
                                 make, cls_out[0].device)

    cls_f, reg_f, obj_f = flatten_head_outputs(cls_out, reg_out, obj_out)
    boxes = decode_boxes(reg_f.float(), grids, stride_v)
    cls_p, obj_p = cls_f.float(), obj_f.float()
    if apply_sigmoid in ("all", "cls"):
        cls_p = torch.sigmoid(cls_p)
    if apply_sigmoid in ("all", "obj"):
        obj_p = torch.sigmoid(obj_p)
    scores = cls_p * obj_p[..., None]
    if single_label:
        # keep only each anchor's max-class entry: zeroed entries never
        # pass score_thr's strict > test
        best = scores.argmax(dim=-1, keepdim=True)
        scores = torch.zeros_like(scores).scatter(
            -1, best, torch.gather(scores, -1, best))
    return _dets(*multiclass_nms_batched(boxes, scores, score_thr, iou_thr,
                                         max_dets))


def gfl_postprocess(cls_scores: Sequence[torch.Tensor],
                    bbox_preds: Sequence[torch.Tensor],
                    img_hw: Tuple[int, int],
                    strides: Sequence[int] = (8, 16, 32, 64, 128),
                    reg_max: int = 16, score_thr: float = 0.01,
                    iou_thr: float = 0.6, max_dets: int = 100,
                    scores_are_logits: bool = True,
                    nms_pre: int = 1000) -> dict:
    """GFL/MPHead decode: per level the top ``nms_pre`` anchors by max
    class score, Integral decode, scores (through a sigmoid when
    ``scores_are_logits``), multiclass NMS."""
    dev = cls_scores[0].device
    centers, = _on_device(
        ("gfl", tuple(img_hw), tuple(strides)),
        lambda: grid_points(img_hw, strides, offset=0.0)[:1], dev)
    counts = [h * w for h, w in featmap_sizes(img_hw, strides)]
    b = cls_scores[0].shape[0]
    cls_l, reg_l, ctr_l, str_l = [], [], [], []
    off = 0
    for c, p, n, s in zip(cls_scores, bbox_preds, counts, strides):
        cf = c.reshape(b, n, c.shape[-1])
        pf = p.reshape(b, n, p.shape[-1])
        ctr = centers[off:off + n]
        off += n
        k = min(nms_pre, n) if nms_pre and nms_pre > 0 else n
        if k < n:
            # max over classes is monotone under sigmoid: ranking logits
            # ranks scores
            _, idx = topk_stable(cf.float().max(dim=-1).values, k)
            cf = torch.gather(cf, 1, idx[..., None].expand(-1, -1,
                                                           cf.shape[-1]))
            pf = torch.gather(pf, 1, idx[..., None].expand(-1, -1,
                                                           pf.shape[-1]))
            ctr = ctr[idx]
        else:
            ctr = ctr.expand(b, n, 2)
        cls_l.append(cf)
        reg_l.append(pf)
        ctr_l.append(ctr)
        str_l.append(torch.full((b, ctr.shape[1]), float(s), device=dev))
    dists = integral_decode(torch.cat(reg_l, 1).float(), reg_max)
    dists = dists * torch.cat(str_l, 1)[..., None]
    boxes = distance2bbox(torch.cat(ctr_l, 1), dists, max_shape=img_hw)
    scores = torch.cat(cls_l, 1).float()
    if scores_are_logits:
        scores = torch.sigmoid(scores)
    return _dets(*multiclass_nms_batched(boxes, scores, score_thr, iou_thr,
                                         max_dets))


def rescale_detections(dets: dict, scale: float,
                       offset: Tuple[float, float] = (0.0, 0.0)) -> dict:
    """Undo a letterbox or resize: boxes back to original image
    coordinates, ``(boxes - (dx, dy, dx, dy)) / scale`` in float32 (or
    wider)."""
    boxes = dets["boxes"]
    boxes = boxes.to(torch.promote_types(boxes.dtype, torch.float32))
    return {**dets, "boxes": unletterbox_boxes(boxes, scale, *offset)}
