"""Single-model eval CLI, the counterpart of ``tools/test.py`` (mmdet
``tools/test.py`` analog):

    python -m glsdet_tpu_torch.tools.test coarse_det \\
        --ckpt work_dirs/coarse_det/epoch_12.pt \\
        --ann data/val.json --img-root data/images

The checkpoint is a state-dict file, a training checkpoint of
``train/loop.py`` or an orbax directory of the JAX package, loaded
shape-matched (``train/loop.py: load_weights``), its raw parameters or,
with ``--use-ema``, its EMA (the JAX CLI's choice; without ``--ckpt`` the
seeded initialisation).  ``eval/runner.py: run_eval`` (``run_eval_tta``
with ``--tta-scales`` / ``--tta-flip``) runs on ``--device``.
``--fuse-conv-bn`` folds BN (``models/fuse.py``); ``--int8`` is dynamic
W8A8 (``ops/quant.py``); ``--int8-static`` calibrates on the first 2 eval
batches (``ops/quant_static.py``; kernel B3 in ``mp_det_res50``'s head
towers on the card), and ``--int8-scales`` loads a scales file, the JAX
CLI's too, or saves the calibration there.  The ``--dist-*`` flags raise
(ROADMAP.md item 14).
"""

from __future__ import annotations

import argparse
import os

from glsdet_tpu_torch.tools.common import (add_device_arg, add_dist_args,
                                           model_dtype, single_process)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--ckpt", required=False,
                    help="checkpoint file or JAX orbax checkpoint dir")
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-root", required=True)
    ap.add_argument("--max-images", type=int)
    ap.add_argument("--use-ema", action="store_true",
                    help="evaluate EMA weights (reference eval default)")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 dynamic-quantized forward (ops/quant.py)")
    ap.add_argument("--int8-static", action="store_true",
                    help="calibrated static-W8A8 forward with an explicit "
                         "int8 backbone (ops/quant_static.py; calibrates "
                         "on the first eval batches)")
    ap.add_argument("--int8-scales", default=None, metavar="PATH",
                    help="saved-scales json: load it instead of "
                         "calibrating when it exists, else calibrate and "
                         "save there (implies --int8-static)")
    ap.add_argument("--fuse-conv-bn", action="store_true",
                    help="fold BN into conv weights before inference "
                         "(reference tools/test.py flag)")
    ap.add_argument("--out", default=None,
                    help="dump COCO-format detection json")
    ap.add_argument("--show-dir", default=None,
                    help="write annotated prediction images here "
                         "(mmdet tools/test.py --show-dir)")
    ap.add_argument("--show-score-thr", type=float, default=0.3)
    ap.add_argument("--tta-scales", type=float, nargs="+", default=None,
                    metavar="S",
                    help="test-time augmentation scales (MultiScaleFlip"
                         "Aug, test_time_aug.py:11), e.g. 0.75 1.0 1.25;"
                         " enables the TTA eval path")
    ap.add_argument("--tta-flip", action="store_true",
                    help="add horizontal-flip variants per TTA scale "
                         "(implies --tta-scales 1.0 when none given)")
    ap.add_argument("--cfg-options", nargs="*", metavar="KEY=VAL")
    ap.add_argument("--format-only", action="store_true",
                    help="write --out without evaluating")
    add_dist_args(ap)
    add_device_arg(ap)
    return ap


def load_model(cfg, ckpt, use_ema: bool):
    """The float32 model on the CPU with the checkpoint's weights
    (``tools/test.py:94-103``): shape-matched, a bare state dict too; no
    match at all raises ``ValueError``."""
    from glsdet_tpu_torch.apis import load_checkpoint
    from glsdet_tpu_torch.models.build import build_model

    model = build_model(cfg, "cpu")
    if ckpt:
        load_checkpoint(cfg, model, ckpt, use_ema, strict=False)
    return model.eval()


def calibration_batches(dataset, cfg, dev, dtype, n: int = 2):
    """The first ``n`` eval batches, letterboxed and normalized on the
    host (``EvalPipeline``), as the model's NCHW input on ``dev``."""
    import torch

    from glsdet_tpu_torch.data.loader import EvalPipeline, eval_loader

    batches = []
    for batch in eval_loader(EvalPipeline(dataset, cfg.data.img_hw),
                             cfg.data.batch_size):
        batches.append(torch.from_numpy(batch["images"]).to(dev, dtype)
                       .permute(0, 3, 1, 2))
        if len(batches) >= n:
            break
    return batches


def main(argv=None):
    """Evaluate; returns ``run_eval``'s ``(result, stats)``."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.format_only and not args.out:
        ap.error("--format-only requires --out")
    single_process(args)

    import copy

    from glsdet_tpu_torch.config import (apply_overrides, get_config,
                                         parse_cfg_options)
    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.eval.runner import run_eval, run_eval_tta
    from glsdet_tpu_torch.models.build import resolve_device

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    apply_overrides(cfg, parse_cfg_options(args.cfg_options))
    dataset = CocoDataset(args.ann, args.img_root)
    model = load_model(cfg, args.ckpt, args.use_ema)
    dtype = model_dtype(cfg, dev)

    if args.fuse_conv_bn:
        from glsdet_tpu_torch.models.fuse import fuse_conv_bn

        model, n_fused = fuse_conv_bn(model)
        print(f"fused {n_fused} conv+bn pairs")

    if args.int8_static or args.int8_scales:
        from glsdet_tpu_torch.ops.quant_static import (calibrate_scales,
                                                       load_scales,
                                                       quantize_static,
                                                       save_scales)

        if args.int8_scales and os.path.exists(args.int8_scales):
            print(f"loading int8 scales from {args.int8_scales}")
            scales = load_scales(args.int8_scales)
        else:
            batches = calibration_batches(dataset, cfg, dev, dtype)
            print(f"calibrating int8 scales on {len(batches)} batches ...")
            scales = calibrate_scales(
                copy.deepcopy(model).to(dev, dtype), batches)
            if args.int8_scales:
                save_scales(args.int8_scales, scales)
                print(f"saved int8 scales to {args.int8_scales}")
        net = quantize_static(model, scales, dtype=dtype, device=dev)
    elif args.int8:
        from glsdet_tpu_torch.ops.quant import quantize_dynamic

        net = quantize_dynamic(model, dtype=dtype, device=dev)
    else:
        net = model.to(dev, dtype)

    # tools/test.py:143, as it is: every family but "yolox" decodes as
    # (cls, reg)
    family = "yolox" if cfg.model.family == "yolox" else "gfl"
    kw = dict(score_thr=cfg.eval.score_thr, nms_iou=cfg.eval.nms_iou,
              max_dets=cfg.eval.max_dets, max_images=args.max_images,
              out_json=args.out, format_only=args.format_only,
              device=dev, dtype=dtype)
    if args.tta_scales or args.tta_flip:
        return run_eval_tta(
            dataset, net, family, cfg.data.img_hw, cfg.model.num_classes,
            tta_scales=tuple(args.tta_scales or [1.0]),
            tta_flip=args.tta_flip, **kw)
    return run_eval(
        dataset, net, family, cfg.data.img_hw, cfg.model.num_classes,
        batch_size=cfg.data.batch_size, show_dir=args.show_dir,
        show_score_thr=args.show_score_thr, **kw)


if __name__ == "__main__":
    main()
