"""Corruption-robustness benchmark (COCO-C style), the counterpart of
``tools/test_robustness.py``.

Behavioral reference: ``yolox-ufp/tools/analysis_tools/test_robustness.py``
(evaluate under every corruption x severity) + ``robustness_eval.py``
(aggregate to mPC / rPC).  Uses the corruption set of
``data/corruptions.py``; reports, per corruption, AP at each severity,
then:

- ``clean AP``: severity-0 baseline
- ``mPC``: mean AP over all (corruption, severity>=1) cells
- ``rPC``: mPC / clean AP

    python -m glsdet_tpu_torch.tools.test_robustness coarse_det --ckpt ... \\
        --ann val.json --img-root images --severities 1 3 5

Each cell is one ``eval/runner.py: run_eval`` (kernel B2 on the card)
over a ``CorruptedDataset``, whose OpenCV twins run on the CPU.
The checkpoint loads as ``tools.test`` loads it (shape-matched, the raw
weights or with ``--use-ema`` the EMA; without ``--ckpt`` the seeded
initialisation).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from glsdet_tpu_torch.tools.common import add_device_arg, model_dtype


def main(argv=None):
    """Run the grid; returns ``{"clean_ap", "severities", "grid", "mPC",
    "rPC"}`` (what ``--out`` writes)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--ckpt", required=False)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-root", required=True)
    ap.add_argument("--corruptions", nargs="*", default=None,
                    help="subset to run (default: full benchmark set)")
    ap.add_argument("--severities", type=int, nargs="*",
                    default=[1, 2, 3, 4, 5])
    ap.add_argument("--max-images", type=int)
    ap.add_argument("--use-ema", action="store_true")
    ap.add_argument("--out", default=None, help="write the result grid "
                                                "as json")
    ap.add_argument("--cfg-options", nargs="*", metavar="KEY=VAL")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from glsdet_tpu_torch.config import (apply_overrides, get_config,
                                         parse_cfg_options)
    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.data.corruptions import (BENCHMARK_CORRUPTIONS,
                                                   CorruptedDataset)
    from glsdet_tpu_torch.eval.runner import run_eval
    from glsdet_tpu_torch.models.build import resolve_device
    from glsdet_tpu_torch.tools.test import load_model

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    apply_overrides(cfg, parse_cfg_options(args.cfg_options))
    dataset = CocoDataset(args.ann, args.img_root)
    dtype = model_dtype(cfg, dev)
    net = load_model(cfg, args.ckpt, args.use_ema).to(dev, dtype)

    # tools/test_robustness.py:84, as it is: every family but "yolox"
    # decodes as (cls, reg)
    family = "yolox" if cfg.model.family == "yolox" else "gfl"

    def ap_for(ds):
        result, _ = run_eval(
            ds, net, family, cfg.data.img_hw, cfg.model.num_classes,
            batch_size=cfg.data.batch_size, score_thr=cfg.eval.score_thr,
            nms_iou=cfg.eval.nms_iou, max_dets=cfg.eval.max_dets,
            max_images=args.max_images, verbose=False, device=dev,
            dtype=dtype)
        return result.ap

    names = args.corruptions or list(BENCHMARK_CORRUPTIONS)
    grid = {}
    clean = ap_for(dataset)
    print(f"clean AP@[.5:.95] = {clean:.4f}")
    for name in names:
        row = []
        for sev in args.severities:
            ap_cs = ap_for(CorruptedDataset(dataset, name, sev))
            row.append(ap_cs)
            print(f"  {name:18s} sev {sev}: AP = {ap_cs:.4f}", flush=True)
        grid[name] = row
    cells = [v for row in grid.values() for v in row]
    mpc = float(np.mean(cells)) if cells else float("nan")
    rpc = mpc / clean if clean > 0 else float("nan")
    print(f"mPC = {mpc:.4f}   rPC = {rpc:.4f}")
    out = {"clean_ap": clean, "severities": args.severities,
           "grid": grid, "mPC": mpc, "rPC": rpc}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
