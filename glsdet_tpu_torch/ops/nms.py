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
from glsdet_tpu_torch.ops.nms_kernel import nms_sorted_cuda

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
    k = boxes_sorted.shape[-2]
    b = boxes_sorted.float()
    later = torch.ones(k, k, dtype=torch.bool,
                       device=b.device).triu(diagonal=1)       # i < j
    suppressor = (pairwise_iou(b, b, offset) > iou_threshold) & later
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
    keep_sorted = nms_sorted_cuda(sorted_boxes.contiguous(),
                                  sorted_scores > NEG_INF / 2,
                                  iou_threshold, offset)
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
    later = torch.ones(k, k, dtype=torch.bool,
                       device=scores.device).triu(diagonal=1)
    decay = torch.where(later, decay, 1.0)
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
