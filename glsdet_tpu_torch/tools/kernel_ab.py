"""Time the NMS, GN and painter kernels of whichever ``glsdet_tpu_torch``
is first on ``sys.path``, so that two checkouts can be compared in one run
on one card (A/B, e.g. the parent commit against the change):

    python3 chip_smoke.py     # saves the path's NMS inputs and painter
                              # rows under glsdet_tpu_torch/_build/
    PYTHONPATH=/path/to/tree python3 glsdet_tpu_torch/tools/kernel_ab.py \\
        --nms-inputs glsdet_tpu_torch/_build/nms_path_inputs.pt \\
        --paint-rows glsdet_tpu_torch/_build/paint_rows.pt --tag B

The timing (``cuda_ms``: eager calls between two CUDA events, the ``ms``
of the smoke's kernel line; ``graph_ms``: the same calls replayed from a
CUDA graph), the GN inputs and affine come from the ``chip_smoke.py`` of
this script's own checkout, loaded by path, so every tree is measured as
the smoke measures its own kernels.

NMS: every saved launch of one ``run_device_batch`` (boxes, valid,
threshold, offset), timed through ``ops/nms_kernel.nms_sorted_cuda``, and
the sums over the batch.  GN, at (16, L, L, 256) for the 1152 bucket's
levels: the bf16 entry ``gn_relu_quant``, the accumulator entry where the
tree has one, and the route that entry replaces (dequantize, cast to
bf16, bf16 entry), each summed over the 8 launches per level of a stage-2
group.  Painter, on the packer's rows of the smoke's 16 frames (made anew
from the same seed): the canvas entry ``assemble_mosaic_cuda_batch`` at
1280 and, for the 1152 bucket, the path entry ``paint_mosaic_inputs_cuda``
where the tree has one and the route it replaced (the canvas entry at
1280, the crop, the bf16 normalize).  Prints one JSON line with the
tree's path, the card and its power limit.  Needs a CUDA card; imports
no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os

import torch

PIXEL_MEAN = (123.675, 116.28, 103.53)     # eval/preprocess.py's, which
PIXEL_STD = (58.395, 57.12, 57.375)        # an older tree does not have
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_smoke():
    """This checkout's chip_smoke.py (the tree under test may have its
    own, first on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nms-inputs", required=True)
    ap.add_argument("--paint-rows", default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    smoke = load_smoke()
    card = smoke.phase_card()
    import glsdet_tpu_torch
    from glsdet_tpu_torch.native import kernels
    from glsdet_tpu_torch.ops import gn_kernel
    from glsdet_tpu_torch.ops.nms_kernel import nms_sorted_cuda

    kernels.load_kernels()
    times = {"ms": smoke.cuda_ms, "graph_ms": smoke.graph_ms}
    nms, nms_total = [], dict.fromkeys(times, 0.0)
    for boxes, valid, thr, offset in torch.load(args.nms_inputs):
        bx, vd = boxes.to(smoke.DEVICE), valid.to(smoke.DEVICE)
        row = {"batch": bx.shape[0], "k": bx.shape[1], "offset": offset,
               "threshold": thr}
        for key, timer in times.items():
            row[key] = timer(lambda: nms_sorted_cuda(bx, vd, thr, offset))
            nms_total[key] += row[key]
        nms.append(row)
    _, gamma, beta = smoke.gn_affine()
    s_out = smoke.GN_S_OUT
    acc_entry = getattr(gn_kernel, "gn_relu_quant_acc", None)
    gn, gn_total = [], {}
    for hw in smoke.LEVELS[1152]:
        acc, deq = smoke.gn_acc_inputs(smoke.N_FRAMES, hw, hw)
        y = (acc.float() * deq).to(torch.bfloat16)
        runs = {
            "bf16": lambda: gn_kernel.gn_relu_quant(y, gamma, beta, s_out),
            "replaced_route": lambda: gn_kernel.gn_relu_quant(
                (acc.float() * deq).to(torch.bfloat16), gamma, beta, s_out)}
        if acc_entry is not None:
            runs["acc"] = lambda: acc_entry(acc, deq, gamma, beta, s_out)
        row = {"hw": hw}
        for name, fn in runs.items():
            for key, timer in times.items():
                row[f"{name}_{key}"] = timer(fn)
                gn_total[f"{name}_{key}"] = (gn_total.get(f"{name}_{key}", 0)
                                             + smoke.GN_PER_LEVEL
                                             * row[f"{name}_{key}"])
        gn.append(row)
        del acc, y
    paint = (paint_times(smoke, args.paint_rows, times)
             if args.paint_rows else None)
    print(json.dumps({
        "tag": args.tag, "tree": glsdet_tpu_torch.__file__, "card": card,
        "nms": nms, "nms_per_batch": nms_total, "gn": gn,
        "gn_per_stage2_group": gn_total, "paint": paint}), flush=True)


def paint_times(smoke, rows_path, times) -> dict:
    """The tree's painter at the path's shapes (module docstring)."""
    import numpy as np

    from glsdet_tpu_torch.ufp import paint_kernel

    rs = np.random.RandomState(0)      # chip_smoke.py's frames
    frames = torch.from_numpy(np.stack([
        rs.randint(0, 255, (*smoke.FRAME_HW, 3), np.uint8)
        for _ in range(smoke.N_FRAMES)])).to(smoke.DEVICE)
    regs = torch.load(rows_path).to(smoke.DEVICE)
    idx = torch.arange(regs.shape[0], dtype=torch.int64).to(smoke.DEVICE)
    mean = torch.tensor(PIXEL_MEAN).to(smoke.DEVICE, torch.bfloat16)
    inv_std = (1.0 / torch.tensor(PIXEL_STD)).to(smoke.DEVICE,
                                                  torch.bfloat16)
    hw, ph = 1152, 1280
    canvas = paint_kernel.assemble_mosaic_cuda_batch
    runs = {
        "canvas_entry": lambda: canvas(frames, idx, regs, ph, ph),
        "replaced_route": lambda: (canvas(frames, idx, regs, ph, ph)[
            :, :hw, :hw] - mean) * inv_std}
    inputs = getattr(paint_kernel, "paint_mosaic_inputs_cuda", None)
    if inputs is not None:
        runs["path_entry"] = lambda: inputs(frames, idx, regs, hw, mean,
                                            inv_std)
    return {f"{name}_{key}": timer(fn) for name, fn in runs.items()
            for key, timer in times.items()}


if __name__ == "__main__":
    main()
