"""COCO-style bbox evaluation in pure numpy, the port's copy of
``glsdet_tpu.eval.coco_eval`` (carried over line for line: the JAX
package's ``__init__`` imports jax, so the port cannot import it, and
``tests/test_torch_eval.py`` holds the two equal bit for bit).

Behavioral reference: pycocotools ``COCOeval`` as configured by the GLSDet
eval scripts — ``cocoEval.params.maxDets = [10, 100, 500]``
(yolox-ufp/ufpmp_det_eval.py:335) — and the vendored editable copy at
``yolox-drone/models/core/cocoeval.py:10``.  Matching rules follow the
COCO protocol: greedy per-category score-descending matching, each GT
matched at most once, detections beyond maxDets dropped, area-range GTs
outside the range ignored, 101-point interpolated precision.

This module is self-contained (no pycocotools dependency) and is the
single eval used by tests, the two-stage eval, and benchmarks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)          # 10
REC_THRS = np.round(np.arange(0.0, 1.01, 0.01), 2)         # 101
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_xywh(dets: np.ndarray, gts: np.ndarray,
              crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """IoU matrix between det and gt boxes in xywh.

    ``crowd``: optional (ng,) bool — crowd gt columns use IoF (inter /
    det area), exactly maskUtils.iou's iscrowd semantics for bbox.
    """
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None, :])
    iy1 = np.maximum(dy1[:, None], gy1[None, :])
    ix2 = np.minimum(dx2[:, None], gx2[None, :])
    iy2 = np.minimum(dy2[:, None], gy2[None, :])
    iw = np.clip(ix2 - ix1, 0, None)
    ih = np.clip(iy2 - iy1, 0, None)
    inter = iw * ih
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    union = d_area + (gts[:, 2] * gts[:, 3])[None, :] - inter
    if crowd is not None and crowd.any():
        union = np.where(np.asarray(crowd, bool)[None, :], d_area, union)
    return inter / np.maximum(union, 1e-12)


@dataclass
class CocoEvalResult:
    stats: np.ndarray            # the 12 standard metrics
    precision: np.ndarray        # (T, R, K, A, M)
    recall: np.ndarray           # (T, K, A, M)
    max_dets: Tuple[int, ...]
    per_class_ap: Optional[np.ndarray] = None  # (K,) AP@[.5:.95] all-area

    @property
    def ap(self) -> float:
        return float(self.stats[0])

    @property
    def ap50(self) -> float:
        return float(self.stats[1])


class CocoEvaluator:
    """COCO bbox evaluation over in-memory GT/detection dicts.

    GT format: {image_id: (boxes_xywh (n,4), labels (n,))} or
    (boxes, labels, iscrowd (n,) bool) — crowd GTs follow pycocotools
    semantics: always-ignore, matched by IoF instead of IoU, and able to
    absorb unlimited detections (cocoeval.py evaluateImg crowd branch).
    Det format: {image_id: (boxes_xywh (m,4), scores (m,), labels (m,))}
    Labels are contiguous category indices [0, K).
    """

    def __init__(self, num_classes: int,
                 max_dets: Sequence[int] = (10, 100, 500),
                 iou_thrs: np.ndarray = IOU_THRS,
                 area_rngs: Optional[Dict[str, Tuple[float, float]]] = None):
        self.num_classes = num_classes
        self.max_dets = tuple(sorted(max_dets))
        self.iou_thrs = np.asarray(iou_thrs)
        # standard COCO ranges by default; the drone reference overrides
        # these (yolox-drone/models/core/cocoeval.py:510 widens "medium"
        # to [32^2, 1e10] and empties "large")
        self.area_rngs = dict(area_rngs) if area_rngs else dict(AREA_RNGS)

    def evaluate(self, gts: dict, dets: dict) -> CocoEvalResult:
        T = len(self.iou_thrs)
        R = len(REC_THRS)
        K = self.num_classes
        A = len(self.area_rngs)
        M = len(self.max_dets)
        area_keys = list(self.area_rngs)
        img_ids = sorted(gts.keys())
        max_det_cap = self.max_dets[-1]

        # per (img, cat) match records
        # evalImgs[k][a] accumulated directly into score-sorted arrays
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for k in range(K):
            per_img = []
            for img_id in img_ids:
                g = gts[img_id]
                g_crowd = (np.asarray(g[2], bool) if len(g) > 2
                           else np.zeros(len(g[0]), bool))
                g_boxes, g_labels = g[0], g[1]
                d = dets.get(img_id)
                if d is None:
                    d_boxes = np.zeros((0, 4))
                    d_scores = np.zeros((0,))
                    d_labels = np.zeros((0,), np.int64)
                else:
                    d_boxes, d_scores, d_labels = d
                gm = np.asarray(g_labels) == k
                dm = d_labels == k
                gb, gc = g_boxes[gm], g_crowd[gm]
                db, ds = d_boxes[dm], d_scores[dm]
                order = np.argsort(-ds, kind="mergesort")[:max_det_cap]
                db, ds = db[order], ds[order]
                ious = _iou_xywh(db, gb, gc)
                per_img.append((gb, gc, db, ds, ious))

            for a, ak in enumerate(area_keys):
                lo, hi = self.area_rngs[ak]
                for m, md in enumerate(self.max_dets):
                    # build global det list with match flags per iou thr
                    all_scores, all_matched, all_ignored = [], [], []
                    npig = 0
                    for gb, gc, db, ds, ious in per_img:
                        g_area = gb[:, 2] * gb[:, 3]
                        # coco protocol: in-range is lo <= area <= hi
                        # (inclusive upper — cocoeval.py:251 uses  > hi),
                        # so an exactly-32^2 gt counts in BOTH small
                        # and medium ranges; crowd gts always ignore
                        g_ignore = (g_area < lo) | (g_area > hi) | gc
                        npig += int((~g_ignore).sum())
                        db_m, ds_m = db[:md], ds[:md]
                        iou_m = ious[:md]
                        nd, ng = len(ds_m), len(gb)
                        dt_match = np.zeros((T, nd), dtype=bool)
                        dt_ignore = np.zeros((T, nd), dtype=bool)
                        if ng:
                            # sort gts: real first, ignored last (coco rule)
                            g_order = np.argsort(g_ignore, kind="mergesort")
                            g_ign_sorted = g_ignore[g_order]
                            g_crowd_sorted = gc[g_order]
                            iou_sorted = iou_m[:, g_order]
                            for t, thr in enumerate(self.iou_thrs):
                                g_used = np.zeros(ng, dtype=bool)
                                for di in range(nd):
                                    best, best_iou = -1, min(thr, 1 - 1e-10)
                                    for gi in range(ng):
                                        # crowd gts absorb unlimited
                                        # matches (cocoeval crowd branch)
                                        if g_used[gi] and not \
                                                g_crowd_sorted[gi]:
                                            continue
                                        # can't leave a real gt for ignored
                                        if best > -1 and not \
                                                g_ign_sorted[best] and \
                                                g_ign_sorted[gi]:
                                            break
                                        if iou_sorted[di, gi] < best_iou:
                                            continue
                                        best_iou = iou_sorted[di, gi]
                                        best = gi
                                    if best == -1:
                                        continue
                                    g_used[best] = True
                                    dt_match[t, di] = True
                                    dt_ignore[t, di] = g_ign_sorted[best]
                        # unmatched dets in ignored area range are ignored
                        d_area = db_m[:, 2] * db_m[:, 3] if nd else \
                            np.zeros((0,))
                        d_out = (d_area < lo) | (d_area > hi)
                        dt_ignore |= (~dt_match) & d_out[None, :]
                        all_scores.append(ds_m)
                        all_matched.append(dt_match)
                        all_ignored.append(dt_ignore)

                    if npig == 0:
                        continue
                    scores = np.concatenate(all_scores)
                    matched = np.concatenate(all_matched, axis=1)
                    ignored = np.concatenate(all_ignored, axis=1)
                    order = np.argsort(-scores, kind="mergesort")
                    matched = matched[:, order]
                    ignored = ignored[:, order]

                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_cum[t], fp_cum[t]
                        nd_t = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd_t else 0.0
                        # precision envelope (monotone decreasing)
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(nd_t - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd_t:
                                q[ri] = pr[pi]
                        precision[t, :, k, a, m] = q

        def _summ(ap=True, iou=None, area="all", md=None):
            aind = area_keys.index(area)
            md = md if md else self.max_dets[-1]
            if md not in self.max_dets:
                # pycocotools quirk: _summarize(1) hard-codes maxDets=100
                # (cocoeval.py:427,460), so stats[0] is -1 whenever 100
                # is not among params.maxDets
                return -1.0
            mind = self.max_dets.index(md)
            if ap:
                s = precision
                if iou is not None:
                    s = s[np.where(self.iou_thrs == iou)[0]]
                s = s[:, :, :, aind, mind]
            else:
                s = recall
                if iou is not None:
                    s = s[np.where(self.iou_thrs == iou)[0]]
                s = s[:, :, aind, mind]
            valid = s[s > -1]
            return float(np.mean(valid)) if valid.size else -1.0

        # AR rows want three det caps; repeat the last when fewer given
        md_lo, md_mid, md_hi = (
            self.max_dets + (self.max_dets[-1],) * 2)[:3]
        stats = np.array([
            # headline AP row is AP@maxDets=100 in the coco protocol
            # (NOT the largest cap — see _summ's quirk note)
            _summ(True, md=100),
            _summ(True, iou=0.5),
            _summ(True, iou=0.75),
            _summ(True, area="small"),
            _summ(True, area="medium"),
            _summ(True, area="large"),
            _summ(False, md=md_lo),
            _summ(False, md=md_mid),
            _summ(False, md=md_hi),
            _summ(False, area="small"),
            _summ(False, area="medium"),
            _summ(False, area="large"),
        ])
        aind = area_keys.index("all")
        mind = len(self.max_dets) - 1
        pc = precision[:, :, :, aind, mind]
        per_class = np.array([
            np.mean(pc[:, :, k][pc[:, :, k] > -1])
            if (pc[:, :, k] > -1).any() else float("nan")
            for k in range(K)
        ])
        return CocoEvalResult(stats, precision, recall, self.max_dets,
                              per_class)


def summarize(res: CocoEvalResult, class_names=None) -> str:
    md = res.max_dets
    names = [
        f"AP@[.5:.95] all {md[-1]}", f"AP@.5 all {md[-1]}",
        f"AP@.75 all {md[-1]}", f"AP small", f"AP medium", f"AP large",
        f"AR {md[0]}", f"AR {md[1] if len(md) > 1 else md[0]}",
        f"AR {md[-1]}", f"AR small", f"AR medium", f"AR large",
    ]
    lines = [f"{n:>24s} = {v:.3f}" for n, v in zip(names, res.stats)]
    if class_names is not None and res.per_class_ap is not None:
        lines.append("per-class AP:")
        for n, v in zip(class_names, res.per_class_ap):
            lines.append(f"{n:>24s} = {v:.3f}")
    return "\n".join(lines)


def eval_recalls(gts: dict, proposals: dict,
                 proposal_nums=(100, 300, 1000),
                 iou_thrs=(0.5,)) -> np.ndarray:
    """Proposal recall matrix (mmdet/core/evaluation/recall.py analog).

    gts: {img: boxes_xyxy}; proposals: {img: (boxes_xyxy, scores)}.
    Returns (len(proposal_nums), len(iou_thrs)) recall fractions.
    """
    out = np.zeros((len(proposal_nums), len(iou_thrs)))
    total_gt = sum(len(v) for v in gts.values())
    if total_gt == 0:
        return out
    for pi, pn in enumerate(proposal_nums):
        for ti, thr in enumerate(iou_thrs):
            hit = 0
            for img_id, gb in gts.items():
                if len(gb) == 0:
                    continue
                pb, ps = proposals.get(img_id, (np.zeros((0, 4)),
                                                np.zeros((0,))))
                order = np.argsort(-ps)[:pn]
                pb = pb[order]
                if len(pb) == 0:
                    continue
                gw = np.concatenate(
                    [gb[:, :2], gb[:, 2:] - gb[:, :2]], axis=1)
                pw = np.concatenate(
                    [pb[:, :2], pb[:, 2:] - pb[:, :2]], axis=1)
                ious = _iou_xywh(pw, gw)  # (P, G)
                hit += int((ious.max(axis=0) >= thr).sum())
            out[pi, ti] = hit / total_gt
    return out
