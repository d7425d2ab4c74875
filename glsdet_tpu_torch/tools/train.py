"""Training CLI, the counterpart of ``tools/train.py`` (behavioral
reference: ``yolox-ufp/tools/train.py``: config, work dir, seed, resume,
``--cfg-options`` overrides):

    python -m glsdet_tpu_torch.tools.train coarse_det \\
        --ann data/train.json --img-root data/images
    python -m glsdet_tpu_torch.tools.train mp_det_res50 \\
        --cfg-options train.base_lr=0.02

The arguments make the ``Config`` the JAX CLI makes, and
``train/loop.py: train`` runs it on ``--device``.  With ``--val-ann`` each
epoch ends with ``eval/runner.py: run_eval`` over the EMA weights.  The
``--dist-*`` flags, or a process count above 1 in ``GLSDET_NUM_PROCESSES``
/ ``SLURM_NTASKS``, raise: one process runs (ROADMAP.md item 14).
"""

from __future__ import annotations

import argparse
import logging

import torch

from glsdet_tpu_torch.config import (apply_overrides, get_config,
                                     parse_cfg_options)
from glsdet_tpu_torch.tools.common import (add_device_arg, add_dist_args,
                                           single_process)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", help="named config (coarse_det, mp_det_res50, "
                                   "...)")
    ap.add_argument("--ann", help="train annotation json")
    ap.add_argument("--img-root", help="train image root")
    ap.add_argument("--work-dir")
    ap.add_argument("--resume", default="")
    ap.add_argument("--load-from", default="",
                    help="weights-only init checkpoint (shape-matched "
                         "partial load; --resume restores full state)")
    ap.add_argument("--val-ann", help="validation annotation json")
    ap.add_argument("--val-img-root")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--max-steps", type=int, help="truncate (smoke tests)")
    ap.add_argument("--cfg-options", nargs="*", metavar="KEY=VAL")
    add_dist_args(ap)
    add_device_arg(ap)
    return ap


def build_config(args):
    """``tools/train.py:55-71``: the named config, the flags, then the
    ``--cfg-options`` overrides."""
    cfg = get_config(args.config)
    if args.ann:
        cfg.data.ann_file = args.ann
    if args.img_root:
        cfg.data.img_root = args.img_root
    if args.work_dir:
        cfg.train.work_dir = args.work_dir
    if args.resume:
        cfg.train.resume = args.resume
    if args.load_from:
        cfg.train.load_from = args.load_from
    if args.seed is not None:
        cfg.train.seed = args.seed
    apply_overrides(cfg, parse_cfg_options(args.cfg_options))
    if args.val_ann:
        cfg.data.val_ann_file = args.val_ann
        cfg.data.val_img_root = args.val_img_root or args.img_root
    return cfg


def make_eval_fn(cfg, device):
    """The per-epoch eval hook: ``run_eval`` of the EMA parameters (with
    the model's BN statistics) over the val set, the family mapped as
    ``tools/train.py:85`` maps it; prints AP and AP50."""
    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.eval.runner import run_eval

    val_ds = CocoDataset(cfg.data.val_ann_file, cfg.data.val_img_root)
    fam = "yolox" if cfg.model.family in ("yolox", "ffa") else "gfl"

    def eval_fn(state, epoch):
        model = state.model
        was_training = model.training
        model.eval()
        try:
            res, _ = run_eval(
                val_ds,
                lambda v, x: torch.func.functional_call(model, v, (x,)),
                cfg.model.family if fam == "yolox" else "gfl",
                cfg.data.img_hw, cfg.model.num_classes,
                batch_size=cfg.data.batch_size,
                score_thr=cfg.eval.score_thr, nms_iou=cfg.eval.nms_iou,
                max_dets=cfg.eval.max_dets,
                variables={**model.state_dict(), **state.ema_params},
                device=device)
        finally:
            model.train(was_training)
        print(f"epoch {epoch}: AP={res.ap:.4f} AP50={res.ap50:.4f}")

    return eval_fn


def main(argv=None):
    """Train; returns the final ``TrainState``."""
    args = parser().parse_args(argv)
    single_process(args)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = build_config(args)

    from glsdet_tpu_torch.train.loop import train

    eval_fn = make_eval_fn(cfg, args.device) if args.val_ann else None
    return train(cfg, max_steps=args.max_steps, eval_fn=eval_fn,
                 device=args.device)


if __name__ == "__main__":
    main()
