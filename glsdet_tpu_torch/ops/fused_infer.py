"""Serving-time fused bottlenecks, the counterpart of
``glsdet_tpu.ops.fused_infer``.

:func:`wrap_model_fused` replaces, in place, every *identity* ResNet
``Bottleneck`` of a model (stride 1, in == 4 * channels: 12 of ResNet-50's
16 blocks) by a :class:`FusedBottleneck`, which runs the block as one
launch of the fused kernel (``ops/bottleneck_kernel.py``,
``csrc/bottleneck.cu``).  Where the JAX package intercepts flax methods and
folds conv+BN at trace time (``wrap_apply_fused``), the port folds once,
when it wraps, from the model's float32 parameters, with the same
arithmetic (``models/fuse.py: fold_conv_bn``, ``BN_EPS`` 1e-3).  So wrap a
model after its weights are loaded; training a wrapped model does not
refold.

At forward time the JAX interceptor's rules decide (its code, that is:
its docstring speaks of a ``channels <= mid_channels`` cap, but the code
has none): training mode, an odd H or a W < 8 runs the stock block;
everything else launches the kernel.  Projection blocks and BasicBlock
depths are never wrapped.

The folded weights are kept as bf16, in the JAX layout and packed for the
kernel (``ops/bottleneck_kernel.py: pack_weights``, once, at the fold), and
the folded biases as float32, and they keep those types through ``.to()``,
``.half()`` and the like, which only move them: the JAX package folds
from the float32 variables and never rounds a bias to bf16.  Inference
only (the kernel has no backward).
"""

from __future__ import annotations

import torch
from torch import nn

from glsdet_tpu_torch.models.fuse import fold_conv_bn
from glsdet_tpu_torch.models.layers import BN_EPS
from glsdet_tpu_torch.models.resnet import Bottleneck, ResNetConv
from glsdet_tpu_torch.ops.bottleneck_kernel import (PLAN, fused_bottleneck,
                                                    pack_weights)

__all__ = ["FusedBottleneck", "wrap_model_fused"]

# the folded operands (weights in the JAX layout, which the plain version
# reads, and packed for the kernel's rings) and their dtypes
_OPERANDS = {"w1": torch.bfloat16, "b1": torch.float32,
             "w2": torch.bfloat16, "b2": torch.float32,
             "w3": torch.bfloat16, "b3": torch.float32,
             "w1p": torch.bfloat16, "w2p": torch.bfloat16,
             "w3p": torch.bfloat16}


def _fold(resnet_conv: ResNetConv, eps: float = BN_EPS):
    """conv+BN of a ``ResNetConv`` -> (folded HWIO kernel, bias) in
    float32, as the JAX package's ``_fold`` gives them."""
    weight, bias = fold_conv_bn(resnet_conv.conv, resnet_conv.bn, eps)
    return weight.permute(2, 3, 1, 0), bias


def is_identity_bottleneck(m: nn.Module) -> bool:
    return (type(m) is Bottleneck and m.conv2.conv.stride == (1, 1)
            and m.conv1.conv.in_channels == 4 * m.conv1.conv.out_channels)


class FusedBottleneck(nn.Module):
    """One identity ``Bottleneck`` (kept as ``block`` for fall-through)
    with its three conv+BN pairs folded for the kernel: ``w1`` (4C, C),
    ``w2`` (9C, C) in the JAX tap order, ``w3`` (C, 4C) in bf16, ``b1``,
    ``b2``, ``b3`` in float32, and ``w1p``, ``w2p``, ``w3p``, the bf16
    weights packed once for the kernel's rings (``pack_weights``; None
    for a width C the kernel does not take)."""

    def __init__(self, block: Bottleneck):
        super().__init__()
        if not is_identity_bottleneck(block):
            raise ValueError("FusedBottleneck wraps identity Bottlenecks only")
        self.block = block
        self.training = block.training
        folded = {}
        for i, conv in enumerate((block.conv1, block.conv2, block.conv3), 1):
            kernel, bias = _fold(conv)
            folded[f"w{i}"] = kernel.reshape(-1, kernel.shape[3])
            folded[f"b{i}"] = bias
        c = folded["w1"].shape[1]
        packed = (pack_weights(folded["w1"], folded["w2"], folded["w3"])
                  if c in PLAN else (None,) * 3)
        folded.update(zip(("w1p", "w2p", "w3p"), packed))
        for name, dtype in _OPERANDS.items():
            t = folded[name]
            self.register_buffer(
                name, None if t is None else t.to(dtype).contiguous(),
                persistent=False)

    def _apply(self, fn, recurse=True):
        # the folded operands follow the module's device, never its dtype
        kept = {n: self._buffers.pop(n) for n in _OPERANDS}
        super()._apply(fn, recurse)
        for n, t in kept.items():
            self._buffers[n] = None if t is None else t.to(
                fn(torch.empty(0, device=t.device)).device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 4C, H, W) -> (B, 4C, H, W).  The kernel path takes the
        NHWC view of channels-last strides without a copy (a plain
        NCHW-contiguous input is copied to that layout) and returns
        channels-last strides."""
        if self.training or x.shape[2] % 2 or x.shape[3] < 8:
            return self.block(x)
        packed = None if self.w1p is None else (self.w1p, self.w2p,
                                                self.w3p)
        y = fused_bottleneck(x.permute(0, 2, 3, 1).contiguous(), self.w1,
                             self.b1, self.w2, self.b2, self.w3, self.b3,
                             packed=packed)
        return y.permute(0, 3, 1, 2)


def wrap_model_fused(model: nn.Module) -> nn.Module:
    """Replace every identity ``Bottleneck`` of ``model`` (in place) by a
    :class:`FusedBottleneck` folded from its current parameters; returns
    ``model``.  Serve fused by handing the result to the pipeline:
    ``TwoStagePipeline(coarse, wrap_model_fused(mp), ...)``."""
    targets = [(parent, name, child)
               for parent in model.modules()
               if not isinstance(parent, FusedBottleneck)
               for name, child in parent.named_children()
               if is_identity_bottleneck(child)]
    for parent, name, child in targets:
        setattr(parent, name, FusedBottleneck(child))
    return model
