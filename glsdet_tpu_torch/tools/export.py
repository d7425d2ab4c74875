"""Model export CLI, the counterpart of ``tools/export.py`` — the
deployment-path analog of the reference's
``tools/deployment/pytorch2onnx.py`` / ``onnx2tensorrt.py``.

The JAX CLI serializes the jitted forward (model + decode + NMS) as
StableHLO via ``jax.export``; the port writes the same function as a
``torch.export`` program (``torch.export.save``, a ``.pt2`` zip
archive), loadable with ``torch.export.load`` without the package's
module tree:

    python -m glsdet_tpu_torch.tools.export coarse_det coarse.pt2 --with-nms --check

The exported function (``tools/common.py: ModelForward``) takes the JAX
CLI's input, a (batch, H, W, 3) float32 normalized NHWC batch, and
computes on ``--device`` in ``tools/common.py: model_dtype``.  ``--with-nms`` records the NMS kernel
(B2) as the ``glsdet_tpu_torch::nms_sorted`` operator
(``ops/nms_kernel.py: nms_sorted_op``), which the reloaded program
launches; the program keeps its export device.  ``--ckpt`` takes a
checkpoint's EMA weights and BN statistics (``train/loop.py:
restore_checkpoint``), as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os

import torch

from glsdet_tpu_torch.tools.common import (ModelForward, add_device_arg,
                                           model_dtype)


def shapes(out):
    """The output's structure with each tensor as its shape (dict keys
    sorted, as ``jax.tree.map`` prints them)."""
    if torch.is_tensor(out):
        return tuple(out.shape)
    if isinstance(out, dict):
        return {k: shapes(out[k]) for k in sorted(out)}
    return type(out)(shapes(o) for o in out)


def main(argv=None):
    """Export (and with ``--check`` reload and re-run); returns ``(eager
    output, reloaded output or None)`` on the zero batch."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("out_path", help="output .pt2 file (a torch.export "
                                     "archive)")
    ap.add_argument("--ckpt")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--with-nms", action="store_true",
                    help="export forward+decode+NMS (end-to-end)")
    ap.add_argument("--check", action="store_true",
                    help="round-trip: deserialize and re-run")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from glsdet_tpu_torch.config import get_config
    from glsdet_tpu_torch.models.build import build_model, resolve_device

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    model = build_model(cfg, "cpu")
    if args.ckpt:
        from glsdet_tpu_torch.train.loop import (build_optimizer,
                                                 make_state_template,
                                                 restore_checkpoint)

        state = make_state_template(cfg, model,
                                    build_optimizer(cfg, 1000, model),
                                    torch.Generator().manual_seed(0))
        state = restore_checkpoint(args.ckpt, state)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(state.ema_params[name])
    dtype = model_dtype(cfg, dev)
    fn = ModelForward(model.eval().to(dev, dtype), cfg, args.with_nms,
                      dtype).eval()
    x = torch.zeros((args.batch_size, *cfg.data.img_hw, 3),
                    dtype=torch.float32, device=dev)
    with torch.inference_mode():
        eager = fn(x)
    program = torch.export.export(fn, (x,))
    torch.export.save(program, args.out_path)
    print(f"exported {os.path.getsize(args.out_path)} bytes to "
          f"{args.out_path} (platforms=({dev.type!r},))")

    again = None
    if args.check:
        loaded = torch.export.load(args.out_path).module()
        with torch.inference_mode():
            again = loaded(x)
        print("round-trip ok:", shapes(again))
    return eager, again


if __name__ == "__main__":
    main()
