#!/usr/bin/env python
"""Two-stage UFPMP eval CLI, the counterpart of ``tools/ufpmp_det_eval.py``.

Behavioral reference: ``yolox-ufp/ufpmp_det_eval.py:196-205``: six
positional arguments (coarse config, coarse checkpoint, mp config, mp
checkpoint, dataset annotation json, image root); runs the two-stage
pipeline over the set and prints COCO metrics with maxDets [10, 100, 500].

    python -m glsdet_tpu_torch.tools.ufpmp_det_eval coarse_det none \\
        mp_det_res50 none data/val.json data/images --fuse-global

A checkpoint is ``none`` (the seeded initialisation of
``models/build.py``), a state-dict file, a training checkpoint of
``train/loop.py`` or an orbax checkpoint directory of the JAX package
(their EMA weights), loaded by ``apis.init_detector``.  Frames go through ``TwoStagePipeline.run_batch``
in chunks of 8; ``--int8-static`` calibrates on the first 4 frames.
``--device cuda`` (the default) runs on the card, ``cpu`` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("first_cfg")
    ap.add_argument("first_ckpt")
    ap.add_argument("second_cfg")
    ap.add_argument("second_ckpt")
    ap.add_argument("dataset_anno")
    ap.add_argument("img_root")
    ap.add_argument("--max-images", type=int)
    ap.add_argument("--out-json", help="write COCO-format detections")
    ap.add_argument("--first-options", nargs="*", metavar="KEY=VAL")
    ap.add_argument("--second-options", nargs="*", metavar="KEY=VAL")
    ap.add_argument("--fuse-global", action="store_true",
                    help="global-local fusion: merge the coarse full-image "
                         "detections with the UFP detections via class-wise "
                         "NMS (merge_results.py semantics)")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 dynamic-quantized forwards (ops/quant.py)")
    ap.add_argument("--int8-static", action="store_true",
                    help="calibrated static-W8A8 forwards with an explicit "
                         "int8 backbone (ops/quant_static.py; calibrates "
                         "on the first frames)")
    ap.add_argument("--int8-scales", default=None, metavar="PATH",
                    help="saved-scales json: load it instead of "
                         "calibrating when it exists, else calibrate and "
                         "save there (implies --int8-static)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")
    return ap


def _checkpoint(ckpt: str):
    """The checkpoint argument as ``init_detector`` takes it."""
    if not ckpt or ckpt == "none":
        return None
    return ckpt


def main(argv=None):
    """Run the eval; returns (CocoEvalResult, stats)."""
    args = parser().parse_args(argv)

    from glsdet_tpu_torch.apis import init_detector
    from glsdet_tpu_torch.config import parse_cfg_options
    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.eval.coco_eval import CocoEvaluator, summarize
    from glsdet_tpu_torch.eval.two_stage import TwoStagePipeline
    from glsdet_tpu_torch.models.build import resolve_device
    from glsdet_tpu_torch.ops.quant_static import load_scales, save_scales

    resolve_device(args.device)
    first = (args.first_cfg, _checkpoint(args.first_ckpt),
             parse_cfg_options(args.first_options))
    second = (args.second_cfg, _checkpoint(args.second_ckpt),
              parse_cfg_options(args.second_options))

    def load(name, ckpt, opts):
        # float32 on the CPU: the pipeline casts them in place, and makes
        # its int8 copies from them
        cfg, model, _ = init_detector(name, ckpt, True, opts, "cpu")
        return cfg, model

    c_cfg, c_model = load(*first)
    m_model = load(*second)[1]

    def make_pipe(quant8, act_scales=None, models=None):
        # a rebuilt pipeline gets fresh float32 models: the first one's
        # were cast in place (init_detector is deterministic)
        c, m = models or (load(*first)[1], load(*second)[1])
        e = c_cfg.eval
        return TwoStagePipeline(
            c, m, tuple(c_cfg.data.img_hw),
            num_classes=c_cfg.model.num_classes,
            ufp_scale=e.ufp_scale,
            mosaic_buckets=e.mosaic_buckets,
            max_regions=e.max_regions,
            bucket_policy=e.bucket_policy,
            pack_mode=e.pack_mode,
            coarse_score_thr=e.coarse_score_thr,
            final_nms_thr=e.chip_nms_iou,
            fuse_global=args.fuse_global,
            fusion_nms_thr=e.fusion_nms_iou,
            quant8=quant8, act_scales=act_scales, device=args.device)

    int8_static = args.int8_static or args.int8_scales is not None
    pipe = make_pipe(False if int8_static else args.int8,
                     models=(c_model, m_model))
    dataset = CocoDataset(args.dataset_anno, args.img_root)
    try:
        if int8_static:
            if args.int8_scales and os.path.exists(args.int8_scales):
                print(f"loading int8 scales from {args.int8_scales}")
                scales = load_scales(args.int8_scales)
            else:
                # calibrate on the first frames, rebuild with int8 models
                calib = [dataset.load_image(r) for r in dataset.records[:4]]
                print("calibrating int8 activation scales on "
                      f"{len(calib)} frames ...")
                scales = pipe.calibrate_int8(calib)
                if args.int8_scales:
                    save_scales(args.int8_scales, scales)
                    print(f"saved int8 scales to {args.int8_scales}")
            pipe.close()
            pipe = make_pipe("static", scales)
        dets_by_img = {}
        coco_dets = []
        records = dataset.records
        if args.max_images:
            records = records[:args.max_images]
        load_s = 0.0
        t0 = time.time()
        chunk_n = 8
        for start in range(0, len(records), chunk_n):
            chunk = records[start:start + chunk_n]
            t = time.perf_counter()
            imgs = [dataset.load_image(r) for r in chunk]
            load_s += time.perf_counter() - t
            for rec, out in zip(chunk, pipe.run_batch(imgs)):
                b = out["boxes"]
                xywh = np.concatenate(
                    [b[:, :2], b[:, 2:] - b[:, :2]], axis=1) \
                    if len(b) else np.zeros((0, 4))
                dets_by_img[rec.img_id] = (xywh, out["scores"],
                                           out["labels"])
                for box, s, lab in zip(xywh, out["scores"], out["labels"]):
                    coco_dets.append({
                        "image_id": rec.img_id,
                        "category_id": dataset.cat_ids[int(lab)],
                        "bbox": [float(v) for v in box],
                        "score": float(s),
                    })
        elapsed = time.time() - t0
    finally:
        pipe.close()
    n = len(dets_by_img)
    print(f"{n} images in {elapsed:.1f}s "
          f"({n / max(elapsed, 1e-9):.2f} img/s)")

    gts = {}
    for rec in dataset.records:
        if rec.img_id not in dets_by_img:
            continue
        b = rec.boxes
        gts[rec.img_id] = (
            np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], axis=1),
            rec.labels)
    res = CocoEvaluator(len(dataset.cat_ids)).evaluate(gts, dets_by_img)
    print(summarize(res, dataset.class_names))

    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(coco_dets, f)
    return res, {"images": n, "elapsed_s": elapsed,
                 "images_per_sec": n / max(elapsed, 1e-9),
                 "frame_read_s": load_s}


if __name__ == "__main__":
    main()
