"""Offline re-evaluation of a saved detection-results json, the
counterpart of ``tools/eval_metric.py`` (behavioral reference:
``yolox-ufp/tools/analysis_tools/eval_metric.py``): the COCO-format
detections that ``tools.test --out`` / ``--format-only`` and
``tools.ufpmp_det_eval --out-json`` write (``image_id``, ``category_id``,
``bbox`` xywh, ``score``), scored against a dataset without running a
model.  Host only.

    python -m glsdet_tpu_torch.tools.eval_metric dets.json --ann data/val.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from glsdet_tpu_torch.data.coco import CocoDataset
from glsdet_tpu_torch.eval.coco_eval import CocoEvaluator, summarize
from glsdet_tpu_torch.tools.common import dataset_gts


def load_results(path, cat_to_contig=None):
    """dets json -> {image_id: (xywh (m,4), scores (m,), labels (m,))}

    ``cat_to_contig``: the dataset's category-id -> contiguous-label map
    (``CocoDataset.cat_to_contig``); the ids as they are when None."""
    with open(path) as f:
        entries = json.load(f)
    by_img = {}
    for e in entries:
        cid = e["category_id"]
        label = cat_to_contig[cid] if cat_to_contig is not None else cid
        by_img.setdefault(int(e["image_id"]), []).append(
            (e["bbox"], e["score"], label))
    out = {}
    for img_id, rows in by_img.items():
        out[img_id] = (
            np.asarray([r[0] for r in rows], np.float64).reshape(-1, 4),
            np.asarray([r[1] for r in rows], np.float64),
            np.asarray([r[2] for r in rows], np.int64))
    return out


def main(argv=None):
    """Score the file; returns the ``CocoEvalResult``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("results", help="detections json (tools.test --out)")
    ap.add_argument("--ann", required=True, help="COCO annotation json")
    ap.add_argument("--max-dets", type=int, nargs="*",
                    default=[10, 100, 500])
    args = ap.parse_args(argv)

    dataset = CocoDataset(args.ann, img_root=".")
    dets = load_results(args.results, dataset.cat_to_contig)
    evaluator = CocoEvaluator(len(dataset.class_names),
                              max_dets=args.max_dets)
    result = evaluator.evaluate(dataset_gts(dataset), dets)
    print(summarize(result, dataset.class_names))
    return result


if __name__ == "__main__":
    main()
