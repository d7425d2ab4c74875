"""VOC-style mAP + log-average miss rate, pure numpy: the port's copy of
``glsdet_tpu.eval.voc_map``, pinned to it by ``tests/test_torch_eval.py``.

Behavioral reference: ``yolox-drone/models/core/utils_map.py`` —
``voc_ap`` (:99, VOC2010+ continuous-interpolation AP), ``get_map``
(:294, per-class greedy matching at a single IoU threshold, default 0.5),
``log_average_miss_rate`` (:26, 9 FPPI points log-spaced in [1e-2, 1]).
The reference reads detection-results/ and ground-truth txt dirs; here the
same math runs on in-memory dicts (the txt I/O lives in the CLI layer).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """Continuous-interpolation AP (utils_map.py:99): envelope + sum of
    rectangle areas between recall change points."""
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def log_average_miss_rate(prec: np.ndarray, rec: np.ndarray,
                          num_images: int) -> Tuple[float, float, float]:
    """lamr over 9 log-spaced FPPI points (utils_map.py:26).

    Returns (lamr, mr at last point, fppi at last point)."""
    if prec.size == 0:
        return 0.0, 1.0, 0.0
    fppi = (1 - prec) * 0  # placeholder replaced below
    # fp count per det rank = rank+1 - tp = (rank+1) * (1 - prec)
    ranks = np.arange(1, len(prec) + 1)
    fp_cum = ranks * (1 - prec)
    fppi = fp_cum / max(num_images, 1)
    mr = 1 - rec
    fppi_tmp = np.concatenate([[-1.0], fppi])
    mr_tmp = np.concatenate([[1.0], mr])
    refs = np.logspace(-2.0, 0.0, num=9)
    ys = []
    for r in refs:
        j = np.where(fppi_tmp <= r)[0][-1]
        ys.append(mr_tmp[j])
    lamr = float(np.exp(np.mean(np.log(np.maximum(np.asarray(ys), 1e-10)))))
    return lamr, float(mr[-1]) if mr.size else 1.0, \
        float(fppi[-1]) if fppi.size else 0.0


def eval_voc_map(
    gts: Dict[int, Tuple[np.ndarray, np.ndarray]],
    dets: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]],
    num_classes: int,
    iou_thr: float = 0.5,
) -> dict:
    """VOC mAP at one IoU threshold.

    GT: {img_id: (boxes_xyxy, labels)}; Det: {img_id: (boxes_xyxy,
    scores, labels)}.  Returns dict with per-class ap/lamr and mAP.
    """
    num_images = len(gts)
    per_class = {}
    for k in range(num_classes):
        # gather
        records = []  # (score, img_id, box)
        n_gt = 0
        gt_by_img = {}
        for img_id, (gb, gl) in gts.items():
            sel = gl == k
            gt_by_img[img_id] = (gb[sel], np.zeros(int(sel.sum()), bool))
            n_gt += int(sel.sum())
        for img_id, (db, ds, dl) in dets.items():
            sel = dl == k
            for b, s in zip(db[sel], ds[sel]):
                records.append((float(s), img_id, b))
        records.sort(key=lambda r: -r[0])

        tp = np.zeros(len(records))
        fp = np.zeros(len(records))
        for i, (s, img_id, b) in enumerate(records):
            gb, used = gt_by_img.get(img_id, (np.zeros((0, 4)), None))
            if len(gb) == 0:
                fp[i] = 1
                continue
            ix1 = np.maximum(b[0], gb[:, 0])
            iy1 = np.maximum(b[1], gb[:, 1])
            ix2 = np.minimum(b[2], gb[:, 2])
            iy2 = np.minimum(b[3], gb[:, 3])
            iw = np.clip(ix2 - ix1, 0, None)
            ih = np.clip(iy2 - iy1, 0, None)
            inter = iw * ih
            union = ((b[2] - b[0]) * (b[3] - b[1])
                     + (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
                     - inter)
            ious = inter / np.maximum(union, 1e-12)
            j = int(np.argmax(ious))
            if ious[j] >= iou_thr and not used[j]:
                tp[i] = 1
                used[j] = True
            else:
                fp[i] = 1

        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        rec = tp_cum / max(n_gt, 1)
        prec = tp_cum / np.maximum(tp_cum + fp_cum, np.spacing(1))
        ap = voc_ap(rec, prec) if n_gt else float("nan")
        lamr, _, _ = log_average_miss_rate(prec, rec, num_images)
        per_class[k] = {"ap": ap, "lamr": lamr, "n_gt": n_gt,
                        "n_det": len(records)}

    aps = [v["ap"] for v in per_class.values() if not np.isnan(v["ap"])]
    return {
        "map": float(np.mean(aps)) if aps else 0.0,
        "per_class": per_class,
        "iou_thr": iou_thr,
    }
