"""Work per image of the two-stage pipeline's stages: the counterpart of
``glsdet_tpu.eval.two_stage.TwoStagePipeline.cost_analysis``, which reads
XLA's ``cost_analysis`` of the two compiled stage programs.  The port runs
eagerly, so it counts what a run of each stage does (``ops/cost.py:
count_cost``) on blank frames and empty region rows, at the shapes
``run_batch`` gives the stages:

- ``flops``: 2 x the multiply-adds of every convolution and matrix product
  of the stage: the model's work, the same on the CPU and the card and
  for the float, static-int8 and fused MP-Det (cuDNN, ``torch._int_mm``,
  the CPU's float64 int8 route and kernel B4 all count the convolution
  they compute, not the padding they add).  Elementwise work (the
  normalisations, the decode, NMS, the painter) is not counted.  XLA's
  count differs: it leaves out the taps that fall on padding and counts
  elementwise work (``tests/test_torch_cost.py`` states the ratio).
- ``bytes``: what the stage's launched operations and kernels read and
  write (each operation's tensor arguments read and outputs written once,
  each kernel as its bound counts it): the device-memory traffic of the
  eager run, bar cache hits.  It depends on the route (bf16 or float32,
  int8 im2col, the fused kernel).
- ``int8_flop_frac``: the share of ``flops`` computed on int8 codes.

XLA's fusion-level ``bytes_traffic`` has no counterpart here: the port has
no fusions, and ``bytes`` already counts each launched operation's own
traffic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from glsdet_tpu_torch.ops.cost import count_cost
from glsdet_tpu_torch.ufp.assembly import regions_to_array


def stage_costs(pipe, image_hw: Tuple[int, int],
                bucket: Optional[int] = None,
                batch: Optional[int] = None) -> dict:
    """``{"batch", "bucket", "coarse": {flops, bytes, int8_flop_frac},
    "stage2": {...}}`` per image of ``pipe`` (a ``TwoStagePipeline``) on
    its first device, as the JAX package chooses them: the batch is
    ``batch`` or ``max_batch``, capped at ``scan_width`` (a group is
    what one run of a stage holds); the bucket is ``bucket`` or the
    ladder's first.  Stage 2 runs without the fusion, as the JAX
    package's analysis does.  The JAX pipeline pads a chunk to a power of
    two and the port does not, so the batch is taken as given."""
    b = batch or pipe.max_batch
    if pipe.scan_width and b > pipe.scan_width:
        b = pipe.scan_width
    bk = bucket or pipe.buckets[0]
    dev = pipe.devices[0]
    frames = torch.zeros((b, *image_hw, 3), dtype=torch.uint8, device=dev)
    idx = torch.zeros((b,), dtype=torch.int64, device=dev)
    regs = torch.from_numpy(regions_to_array([], pipe.max_regions))
    regs = regs.expand(b, -1, -1).contiguous().to(dev)
    out = {"batch": b, "bucket": bk}
    for name, run in (("coarse", lambda: pipe.coarse_packed(frames)),
                      ("stage2", lambda: pipe.stage2_packed(frames, idx,
                                                            regs, bk))):
        with count_cost() as counter:
            run()
        per = counter.as_dict()
        per["flops"] /= b
        per["bytes"] /= b
        out[name] = per
    return out
