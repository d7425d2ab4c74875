"""Fixed-shape greedy NMS, the counterpart of ``glsdet_tpu.ops.nms``.

Every NMS of the serving path meets in :func:`batched_nms`: boxes are
shifted by ``label * coord_bound`` so one class-agnostic pass is
class-wise, sorted by score, and handed to the CUDA kernel
(``ops/nms_kernel.py``) on the card or to :func:`nms_sorted_plain` on the
CPU.  Padding rows carry ``score = NEG_INF`` and are never kept.

Sorting: every ``jnp.argsort(-s)`` and ``lax.top_k`` of the JAX package
becomes a stable descending sort (plus a slice), because ``torch.topk``
does not fix the order of ties and the JAX sorts break ties by the lower
index.
"""

from __future__ import annotations

import torch

from glsdet_tpu_torch.ops.boxes import pairwise_iou
from glsdet_tpu_torch.ops.nms_kernel import nms_sorted_cuda, nms_sorted_op

NEG_INF = -1e9


def topk_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest, ties by lower
    index.  Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_sorted_plain(boxes_sorted: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float, offset: float = 0.0
                     ) -> torch.Tensor:
    """Plain PyTorch greedy NMS over score-sorted boxes.

    Args:
        boxes_sorted: (B, K, 4) xyxy, descending score order.
        valid: (B, K) bool; padding rows False.

    Returns (B, K) bool keep mask in the sorted order.  Greedy NMS is the
    unique fixpoint of ``keep[j] = valid[j] and no kept i < j has
    IoU(i, j) > thr``; iterating the full-vector update from ``keep =
    valid`` reaches it (as ``glsdet_tpu.ops.nms.nms`` does).
    """
    b = boxes_sorted.float()
    return _greedy(pairwise_iou(b, b, offset) > iou_threshold, valid)


def _later(k: int, device) -> torch.Tensor:
    """(K, K) bool, True where i < j."""
    return torch.ones(k, k, dtype=torch.bool, device=device).triu(diagonal=1)


def _greedy(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy suppression over sorted rows: the fixpoint of ``keep[j] =
    valid[j] and no kept i < j has overlap[i, j]``, (..., K) bool."""
    k = valid.shape[-1]
    suppressor = overlap & _later(k, valid.device)
    keep = valid
    for _ in range(k):
        new = valid & ~(keep[..., :, None] & suppressor).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                class_ids: torch.Tensor, iou_threshold: float,
                offset: float = 0.0, coord_bound: float = 8192.0):
    """Class-wise greedy NMS via the coordinate-offset trick.

    Args:
        boxes: (B, K, 4); scores: (B, K); class_ids: (B, K) int.
        coord_bound: any value larger than the max image dimension.

    Returns (keep (B, K) bool over the input order, (B, K) descending
    score order).
    """
    shifted = boxes + class_ids.to(boxes.dtype)[..., None] * coord_bound
    sorted_scores, order = torch.sort(scores, dim=-1, descending=True,
                                      stable=True)
    sorted_boxes = torch.gather(
        shifted.float(), -2, order[..., None].expand(*order.shape, 4))
    nms = nms_sorted_op if torch.compiler.is_exporting() \
        else nms_sorted_cuda
    keep_sorted = nms(sorted_boxes.contiguous(),
                      sorted_scores > NEG_INF / 2, iou_threshold, offset)
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return keep, order


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.3, sigma: float = 0.5,
             score_threshold: float = 0.001,
             method: str = "gaussian") -> torch.Tensor:
    """Soft-NMS over one image's (K, 4) boxes and (K,) scores, gaussian
    or linear decay: walking the score order, every later box's score is
    multiplied by its decay against box i, while box i's (already
    decayed) score is at least ``score_threshold``.  Returns the
    re-weighted scores in the input order; the caller filters them.
    A plain function: no kernel stands behind it (the JAX package's is an
    XLA loop too)."""
    if method not in ("gaussian", "linear"):
        raise ValueError(f"method {method!r}: expected 'gaussian' or "
                         "'linear'")
    k = scores.shape[0]
    s, order = torch.sort(scores, descending=True, stable=True)
    iou_mat = pairwise_iou(boxes[order], boxes[order])
    if method == "gaussian":
        decay = torch.exp(-(iou_mat ** 2) / sigma)
    else:
        decay = torch.where(iou_mat > iou_threshold, 1.0 - iou_mat, 1.0)
    decay = torch.where(_later(k, scores.device), decay, 1.0)
    for i in range(k):
        s = s * torch.where(s[i] >= score_threshold, decay[i], 1.0)
    return torch.zeros_like(scores).scatter(0, order, s)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for (B, N, ...) x and (B, k) idx."""
    idx = idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(-1, -1, *x.shape[2:]))


def multiclass_nms_batched(boxes: torch.Tensor, scores: torch.Tensor,
                           score_thr: float, iou_threshold: float,
                           max_per_img: int, small_budget: int = 512):
    """Batched mmdet-style ``multiclass_nms`` with fixed output size and
    the adaptive candidate ladder of the JAX package.

    Args:
        boxes: (B, N, 4) shared boxes per anchor.
        scores: (B, N, C) per-class scores (sigmoid, no background).

    Returns (B, max_per_img) boxes, scores, labels and valid, ranked by
    score.  The JAX package's ladder runs the NMS over the top
    ``small_budget`` rows when every image's candidates fit there, and
    over the full budget otherwise; both give the same output, because
    padding rows (``NEG_INF`` scores) are inert.  The port always runs
    the full budget: the choice would need the candidate count on the
    host, a device sync per call; where the smaller budget would do, the
    full one costs the NMS and ranking 0.056 ms more a call on an H100
    (PERF.md §6).
    ``small_budget`` is kept for the JAX signature and changes nothing.
    """
    del small_budget
    b, n, c = scores.shape
    budget = min(n * c, 4 * max_per_img if max_per_img > 0 else n * c)

    scores2d = torch.where(scores > score_thr, scores,
                           torch.full_like(scores, NEG_INF))
    if n > budget:
        # top-`budget` anchors by max class score contain every top-
        # `budget` (anchor, class) pair: an exact prefilter
        _, a_idx = topk_stable(scores2d.max(dim=-1).values, budget)
        scores2d = _take(scores2d, a_idx)
        boxes = _take(boxes, a_idx)
        n = budget
    flat_boxes = boxes.repeat_interleave(c, dim=1)           # (B, n*C, 4)
    flat_labels = torch.arange(c, device=scores.device).repeat(n)
    top_scores, top_idx = topk_stable(scores2d.reshape(b, n * c), budget)
    top_boxes = _take(flat_boxes, top_idx)
    top_labels = flat_labels[top_idx]

    keep, _ = batched_nms(top_boxes, top_scores, top_labels, iou_threshold)
    kept = torch.where(keep, top_scores, torch.full_like(top_scores, NEG_INF))
    out_s, oi = topk_stable(kept, max_per_img)
    valid = out_s > NEG_INF / 2
    return (_take(top_boxes, oi), torch.where(valid, out_s, 0.0),
            torch.gather(top_labels, 1, oi), valid)


def multiclass_nms(mlvl_boxes: torch.Tensor, mlvl_scores: torch.Tensor,
                   score_thr: float, iou_threshold: float,
                   max_per_img: int):
    """mmdet ``multiclass_nms`` for one image: (N, 4) shared boxes and
    (N, C) per-class scores -> (max_per_img, 4) boxes, (max_per_img,)
    scores, labels and valid, ranked by score.  It is
    :func:`multiclass_nms_batched` at B = 1, so on the card it runs the
    NMS kernel."""
    out = multiclass_nms_batched(mlvl_boxes[None], mlvl_scores[None],
                                 score_thr, iou_threshold, max_per_img)
    return tuple(t[0] for t in out)


def diou_nms(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.7):
    """DIoU-NMS over one image's (K, 4) boxes and (K,) scores: greedy
    suppression where IoU minus the normalized squared distance of the
    centres exceeds ``iou_threshold``.  Returns (keep (K,) bool over the
    input order, (K,) descending score order).  Plain PyTorch: the JAX
    package's is an XLA loop, no kernel stands behind it."""
    k = scores.shape[0]
    _, order = torch.sort(scores, descending=True, stable=True)
    b = boxes[order]
    valid = scores[order] > NEG_INF / 2
    iou_mat = pairwise_iou(b, b)
    cx = (b[:, 0] + b[:, 2]) / 2
    cy = (b[:, 1] + b[:, 3]) / 2
    d2 = (cx[:, None] - cx[None, :]) ** 2 + (cy[:, None] - cy[None, :]) ** 2
    ex1 = torch.minimum(b[:, None, 0], b[None, :, 0])
    ey1 = torch.minimum(b[:, None, 1], b[None, :, 1])
    ex2 = torch.maximum(b[:, None, 2], b[None, :, 2])
    ey2 = torch.maximum(b[:, None, 3], b[None, :, 3])
    c2 = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2
    diou = iou_mat - d2 / torch.clamp(c2, min=1e-9)
    keep_sorted = _greedy(diou > iou_threshold, valid)
    keep = torch.zeros(k, dtype=torch.bool, device=scores.device)
    return keep.scatter(0, order, keep_sorted), order


def nms_match(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float):
    """mmcv ``nms_match``: greedy NMS over one image's (K, 4) boxes, each
    suppressed box assigned to its group leader, the highest-scoring kept
    box with IoU > ``iou_threshold``.  Returns keep (K,) bool (the
    leaders) and group (K,) int32: each box's leader's input index
    (leaders map to themselves, padding rows with ``score <= NEG_INF / 2``
    to -1).  The NMS is :func:`batched_nms` with one class, the kernel on
    the card."""
    k = scores.shape[0]
    keep, _ = batched_nms(boxes[None], scores[None],
                          torch.zeros((1, k), dtype=torch.int64,
                                      device=scores.device), iou_threshold)
    keep = keep[0]
    valid = scores > NEG_INF / 2
    cand = keep[:, None] & (pairwise_iou(boxes, boxes) > iou_threshold)
    cand_scores = torch.where(cand, scores[:, None],
                              torch.full_like(cand, NEG_INF, dtype=scores.dtype))
    leader = cand_scores.argmax(dim=0).to(torch.int32)
    has_leader = cand_scores.max(dim=0).values > NEG_INF / 2
    self_idx = torch.arange(k, dtype=torch.int32, device=scores.device)
    group = torch.where(keep, self_idx,
                        torch.where(has_leader, leader, self_idx))
    return keep, torch.where(valid, group, torch.full_like(group, -1))
