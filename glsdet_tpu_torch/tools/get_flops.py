"""Model FLOPs/params CLI, the counterpart of ``tools/get_flops.py``
(behavioral reference: ``yolox-ufp/tools/analysis_tools/get_flops.py``):
report the parameter count and the FLOPs of one forward.

    python -m glsdet_tpu_torch.tools.get_flops coarse_det [--shape 640 640]

The parameters are the model's ``nn.Parameter``s, the JAX CLI's flax
``params`` collection (BatchNorm statistics excluded).  The FLOPs are
``torch.utils.flop_counter.FlopCounterMode``'s count of one forward at
batch 1: 2 x the multiply-accumulates of the convolutions and matrix
products, nothing else (no normalisation, activation or elementwise
work).  The JAX CLI prints XLA's ``cost_analysis()["flops"]`` of the
compiled program, which counts elementwise work too, so the two numbers
differ (``tests/test_torch_tools_model.py`` records their ratio).
"""

from __future__ import annotations

import argparse

from glsdet_tpu_torch.tools.common import add_device_arg


def main(argv=None):
    """Print the three lines; returns ``(n_params, flops)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default="coarse_det")
    ap.add_argument("--shape", type=int, nargs=2, default=None,
                    help="input H W (default: config img_hw)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.models.build import build_model

    cfg = get_config(args.config)
    hw = tuple(args.shape) if args.shape else cfg.data.img_hw
    model = build_model(cfg, args.device)
    x = torch.zeros((1, 3, *hw), dtype=torch.float32,
                    device=next(model.parameters()).device)
    n_params = sum(p.numel() for p in model.parameters())
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        model(x)
    flops = int(counter.get_total_flops())
    print(f"config: {cfg.name}  input: 1x{hw[0]}x{hw[1]}x3")
    print(f"params: {n_params / 1e6:.2f} M")
    print(f"flops:  {flops / 1e9:.2f} GFLOPs/image "
          "(2 x MACs of convolutions and matrix products)")
    return n_params, flops


if __name__ == "__main__":
    main()
