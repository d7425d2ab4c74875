"""W8A8 dynamic-quantized inference, the counterpart of
``glsdet_tpu/ops/quant.py`` (``TwoStagePipeline(quant8=True)``).

No calibration: weights get symmetric per-output-channel scales
(``s_w = max|w[o]| / 127``) and activations symmetric per-image scales
(``s_x[b] = max|x[b]| / 127``) computed on the fly; the convolution runs
int8 x int8 -> int32 (``ops/int8_conv.py``), then dequantizes in float32,
adds the bias and returns the compute dtype.  :func:`quantize_dynamic`
replaces every eligible ``Conv2d`` of a copy of the model, once: at least
``min_channels`` in and out channels, a kernel area of at least
``min_kernel_area``, groups 1 or depthwise, any dilation (LSK's 7x7
depthwise conv at dilation 3 among them), as the JAX interceptor
(``quant.py:_make_interceptor``) takes them.  The norms and activations
around the convolutions stay as they are.  Inference only.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from glsdet_tpu_torch.models.build import resolve_device
from glsdet_tpu_torch.ops.int8_conv import (Int8Conv2d, Int8Module,
                                            place_quantized, quantize_weight)

__all__ = ["DynamicQuantConv2d", "quantize_dynamic"]


class DynamicQuantConv2d(Int8Module):
    """A ``Conv2d`` with per-image activation scales (``quant.py:
    quantize_conv_output``); NCHW in, NCHW out."""

    def __init__(self, m: nn.Conv2d):
        super().__init__()
        q_w, s_w = quantize_weight(m.weight)
        self.conv = Int8Conv2d(q_w, m.stride, m.padding, m.groups,
                               m.dilation)
        self.register_buffer("s_w", s_w)
        self.register_buffer("bias", None if m.bias is None
                             else m.bias.detach().float().clone())

    def forward(self, x):
        xf = x.permute(0, 2, 3, 1).float()
        s_x = torch.clamp(xf.abs().amax(dim=(1, 2, 3), keepdim=True),
                          min=1e-8) / 127.0                     # (B,1,1,1)
        q = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
        y = self.conv(q).float() * (s_x * self.s_w)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype).permute(0, 3, 1, 2)


def _eligible(m: nn.Module, min_channels: int, min_kernel_area: int) -> bool:
    if not isinstance(m, nn.Conv2d) or isinstance(m.padding, str):
        return False
    kh, kw = m.kernel_size
    return (m.in_channels >= min_channels and m.out_channels >= min_channels
            and m.groups in (1, m.in_channels)
            and (m.groups == 1 or m.out_channels == m.in_channels)
            and kh * kw >= min_kernel_area)


def _rewrite(module: nn.Module, min_channels: int,
             min_kernel_area: int) -> None:
    for name, child in list(module.named_children()):
        if _eligible(child, min_channels, min_kernel_area):
            setattr(module, name, DynamicQuantConv2d(child))
        else:
            _rewrite(child, min_channels, min_kernel_area)


@torch.no_grad()
def quantize_dynamic(model: nn.Module, min_channels: int = 64,
                     min_kernel_area: int = 9,
                     dtype: torch.dtype = torch.float32,
                     device="cuda") -> nn.Module:
    """A dynamic-W8A8 copy of ``model`` (float32 weights) on ``device``
    (``"cuda"`` raises without a GPU), computing in ``dtype`` outside the
    int8 convolutions.  The defaults
    quantize the 3x3+ convolutions with >= 64 channels, as the JAX
    package's.  ``model`` itself is left as it is; the copy's tensors
    hold no autograd history of its."""
    device = resolve_device(device)
    q = copy.deepcopy(model).float().eval()
    _rewrite(q, min_channels, min_kernel_area)
    return place_quantized(q, device, dtype)
