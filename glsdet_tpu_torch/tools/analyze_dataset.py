"""Dataset object/scale statistics, the counterpart of
``tools/analyze_dataset.py`` (yolox-drone basetools analog).

Reference behavior: ``yolox-drone/tools/basetools/analysis_objects.py``
(per-class object-area statistics) and ``analysis_scale.py`` (per-class
scale-imbalance parameter: for each class sort box areas ascending and
average the consecutive-area ratios ``area[i]/area[i-1]`` — 1.0 means
perfectly uniform scales, larger means a long scale tail).  Reads the
canonical COCO json (what ``tools.convert_datasets`` emits) and prints a
per-class table:

    count, area mean/median, small/medium/large split (COCO 32^2/96^2
    thresholds — also the UFP upscale-factor boundaries,
    unified_foreground_packing.py:96-101), mean aspect ratio, and the
    scale-imbalance parameter.

Usage:
    python -m glsdet_tpu_torch.tools.analyze_dataset annotations.json [--json]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def scale_imbalance(areas: np.ndarray) -> float:
    """Reference ``analysis_scale.cal_scale_parameter_per_image``
    semantics: mean ratio of consecutive sorted areas (first box
    compares to itself, ratio 1)."""
    if len(areas) == 0:
        return 0.0
    a = np.sort(areas.astype(np.float64))
    prev = np.concatenate([a[:1], a[:-1]])
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(prev > 0, a / prev, 1.0)
    return float(r.mean())


def analyze(coco: dict) -> dict:
    cats = {c["id"]: c.get("name", str(c["id"]))
            for c in coco.get("categories", [])}
    per_class = {cid: [] for cid in cats}
    for ann in coco.get("annotations", []):
        if ann.get("iscrowd"):
            continue
        w, h = float(ann["bbox"][2]), float(ann["bbox"][3])
        per_class.setdefault(ann["category_id"], []).append((w, h))

    out = {}
    for cid in sorted(per_class):
        wh = np.asarray(per_class[cid], np.float64).reshape(-1, 2)
        areas = wh.prod(axis=1)
        small = int((areas < 32 ** 2).sum())
        large = int((areas >= 96 ** 2).sum())
        out[cats.get(cid, str(cid))] = {
            "count": int(len(wh)),
            "area_mean": round(float(areas.mean()), 1) if len(wh) else 0,
            "area_median": (round(float(np.median(areas)), 1)
                            if len(wh) else 0),
            "small": small,
            "medium": int(len(wh)) - small - large,
            "large": large,
            "aspect_mean": (round(float((wh[:, 0]
                                         / np.maximum(wh[:, 1], 1e-6))
                                        .mean()), 3) if len(wh) else 0),
            "scale_imbalance": round(scale_imbalance(areas), 3),
        }
    n_img = len(coco.get("images", []))
    n_ann = sum(v["count"] for v in out.values())
    out["_total"] = {
        "images": n_img,
        "objects": n_ann,
        "objects_per_image": round(n_ann / n_img, 2) if n_img else 0.0,
    }
    return out


def main(argv=None):
    """Print the table (or ``--json``); returns :func:`analyze`'s dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("annotations", help="COCO json")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable json instead of a table")
    args = ap.parse_args(argv)

    with open(args.annotations) as f:
        coco = json.load(f)
    stats = analyze(coco)
    if args.json:
        print(json.dumps(stats, indent=2))
        return stats
    total = stats.pop("_total")
    hdr = (f"{'class':<16}{'count':>8}{'area_mean':>11}{'median':>9}"
           f"{'small':>7}{'med':>6}{'large':>7}{'aspect':>8}{'SI':>7}")
    print(hdr)
    print("-" * len(hdr))
    for name, s in stats.items():
        print(f"{name:<16}{s['count']:>8}{s['area_mean']:>11}"
              f"{s['area_median']:>9}{s['small']:>7}{s['medium']:>6}"
              f"{s['large']:>7}{s['aspect_mean']:>8}"
              f"{s['scale_imbalance']:>7}")
    print(f"\n{total['images']} images, {total['objects']} objects "
          f"({total['objects_per_image']}/image)")
    return {**stats, "_total": total}


if __name__ == "__main__":
    main()
