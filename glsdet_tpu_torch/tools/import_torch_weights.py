"""Import a reference torch ``.pth`` checkpoint into the port.

The counterpart of the JAX package's ``tools/import_torch_weights.py``,
with its arguments:

    # coarse detector (yolox-drone YoloBody .pth)
    python -m glsdet_tpu_torch.tools.import_torch_weights yolox_s.pth \\
        coarse.pt --arch yolox --config coarse_det

    # stage-2 detector (yolox-ufp mmdet GFL/MP-Det .pth)
    python -m glsdet_tpu_torch.tools.import_torch_weights mp_det.pth \\
        mp.pt --arch mpdet --config mp_det_res50

Key rewriting lives in ``utils/torch_import.py``; the tensors keep their
layout (both sides are OIHW).  The output is a ``torch.save`` file that
``apis.init_detector``, ``apis.TwoStageDetector``, ``serve.archive_model``
and ``train/loop.py: load_weights`` (``train.load_from``) read: the
model's ``state_dict``, or, where an MP-Det checkpoint carries MPHead's
BoIW dictionary buffers (``_embedding``, ``_pos_embedding_ptr``,
``_proxies_prob``), ``{"model": state_dict, "boiw": {...}}``, whose
dictionary ``train()`` resumes with.  mmcv ``{"state_dict": ...}`` and
``{"model": ...}`` wrappers are unwrapped.  With ``--no-strict``,
tensors the checkpoint does not cover keep the model's seeded
initialisation (``models/build.py``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src", help="torch .pth checkpoint")
    ap.add_argument("dst", help="output .pt file")
    ap.add_argument("--arch", choices=("yolox", "mpdet"), required=True,
                    help="state-dict naming family: yolox-drone YoloBody "
                         "or mmdet-style GFL/MP-Det")
    ap.add_argument("--config", default=None,
                    help="named config to build the target model "
                         "(default: coarse_det / mp_det_res50 per arch)")
    ap.add_argument("--cfg-options", nargs="*", default=[],
                    help="KEY=VAL dotted config overrides")
    ap.add_argument("--no-strict", action="store_true",
                    help="shape-matched partial load: skip unmatched "
                         "keys / leave uncovered tensors at init instead "
                         "of failing (yolox-drone train.py:139-165)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Run the import; returns ``(written object, ImportReport)``."""
    from glsdet_tpu_torch.config import (apply_overrides, get_config,
                                         parse_cfg_options)
    from glsdet_tpu_torch.models.build import build_model
    from glsdet_tpu_torch.utils.torch_import import (convert_mpdet,
                                                     convert_yolox_drone)

    args = parse_args(argv)
    raw = torch.load(args.src, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "state_dict" in raw:   # mmcv wrapper
        raw = raw["state_dict"]
    if isinstance(raw, dict) and "model" in raw and all(
            not torch.is_tensor(v) for v in raw.values()):
        raw = raw["model"]
    state = {k: v.detach().cpu() for k, v in raw.items()
             if torch.is_tensor(v)}
    print(f"loaded {len(state)} tensors from {args.src}")

    cfg_name = args.config or (
        "coarse_det" if args.arch == "yolox" else "mp_det_res50")
    cfg = get_config(cfg_name)
    apply_overrides(cfg, parse_cfg_options(args.cfg_options))
    model = build_model(cfg, device="cpu")

    convert = convert_yolox_drone if args.arch == "yolox" else convert_mpdet
    sd, report = convert(state, model, strict=not args.no_strict)
    print(report.summary())
    for key in report.unmatched[:10]:
        print(f"  unmatched: {key}")
    for key in report.missing[:10]:
        print(f"  left at init: {key}")
    if args.no_strict and report.missing:
        # partial load: the uncovered tensors from the seeded init, so
        # the file stays self-contained and loads strictly
        sd = {k: sd.get(k, v) for k, v in model.state_dict().items()}

    out = sd
    if args.arch == "mpdet" and "bbox_head._embedding" in state:
        # BoIW ring buffer -> the boiw section (train/boiw.py: BoIWState)
        out = {"model": sd, "boiw": {
            "embedding": state["bbox_head._embedding"].float(),
            "ptr": state["bbox_head._pos_embedding_ptr"].long(),
            "proxies_prob": state["bbox_head._proxies_prob"].float(),
            "beta": torch.zeros(()),
        }}
        print("extracted BoIW dictionary buffers -> boiw section")

    torch.save(out, args.dst)
    names = {n for n, _ in model.named_parameters()}
    n_params = sum(v.numel() for k, v in sd.items() if k in names)
    print(f"wrote {args.dst} ({n_params / 1e6:.2f}M params); load with "
          f"--load-from")
    return out, report


if __name__ == "__main__":
    main()
