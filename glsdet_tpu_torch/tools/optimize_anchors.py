"""Anchor/size-statistics optimization CLI, the counterpart of
``tools/optimize_anchors.py`` (behavioral reference:
``yolox-ufp/tools/analysis_tools/optimize_anchors.py``, k-means over GT
box sizes, and yolox-drone's per-class size stats table).  YOLOX is
anchor-free, so the main use is dataset size analysis + the UFP
scale-factor thresholds; the k-means output also seeds anchor-based
ablations.  Host numpy, the JAX CLI's arithmetic and lines.

    python -m glsdet_tpu_torch.tools.optimize_anchors data/train.json --k 9
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    """Print the size statistics and the k-means anchors; returns the
    anchors (k, 2) as (w, h), smallest area first."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ann_file")
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)

    from glsdet_tpu_torch.data.coco import CocoDataset

    ds = CocoDataset(args.ann_file, img_root="")
    whs = []
    for rec in ds.records:
        wh = rec.boxes[:, 2:4] - rec.boxes[:, :2]
        whs.append(wh)
    whs = np.concatenate(whs)
    areas = whs[:, 0] * whs[:, 1]
    print(f"{len(whs)} boxes; mean wh = {whs.mean(0).round(1)}")
    print(f"area quantiles (10/50/90): "
          f"{np.percentile(areas, [10, 50, 90]).round(1)}")
    small = (areas < 32 * 32).mean()
    med = ((areas >= 32 * 32) & (areas < 96 * 96)).mean()
    print(f"UFP factor mix: <32^2 (4x): {small:.1%}, "
          f"<96^2 (2x): {med:.1%}, else (1x): {1 - small - med:.1%}")

    # IoU-distance k-means over (w, h) — the classic anchor recipe
    rs = np.random.RandomState(0)
    centers = whs[rs.choice(len(whs), args.k, replace=False)]
    for _ in range(args.iters):
        inter = (np.minimum(whs[:, None, 0], centers[None, :, 0])
                 * np.minimum(whs[:, None, 1], centers[None, :, 1]))
        union = (whs[:, 0] * whs[:, 1])[:, None] + \
            (centers[:, 0] * centers[:, 1])[None, :] - inter
        iou = inter / np.maximum(union, 1e-12)
        assign = iou.argmax(1)
        for j in range(args.k):
            sel = assign == j
            if sel.any():
                centers[j] = np.median(whs[sel], axis=0)
    order = np.argsort(centers[:, 0] * centers[:, 1])
    print("anchors (w, h):")
    for c in centers[order]:
        print(f"  ({c[0]:.1f}, {c[1]:.1f})")
    return centers[order]


if __name__ == "__main__":
    main()
