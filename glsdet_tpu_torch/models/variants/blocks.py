"""Identity-initialised convs and the reverse-Focus upsampler, the
counterparts of ``glsdet_tpu.models.variants.blocks`` (NCHW;
yolox-drone ``models/block/IdentityConv.py``).

- :class:`IdentityConv`: a conv whose kernel starts as a dirac delta
  (output f copies input f % in_g at the true kernel centre) and whose
  bias starts at zero, so inserting it into a trained net is a no-op.
- :class:`ReverseFocus`: the inverse of the Focus stem, a ConvNormAct to
  4 * out channels whose channel groups g = channel % 4 interleave into a
  2x map: g0 (even row, even col), g1 (odd, even), g2 (even, odd), g3
  (odd, odd).
"""

from __future__ import annotations

import torch
from torch import nn

from glsdet_tpu_torch.models.layers import Conv2d, ConvNormAct


class _DiracConv2d(Conv2d):
    def flax_init(self, generator: torch.Generator) -> None:
        out, in_g, kh, kw = self.weight.shape
        self.weight.zero_()
        for f in range(out):
            self.weight[f, f % in_g, kh // 2, kw // 2] = 1.0
        self.bias.zero_()


class IdentityConv(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 kernel_size: int = 3, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = _DiracConv2d(in_channels, features, kernel_size, stride,
                                 kernel_size // 2, groups=groups)

    def forward(self, x):
        return self.conv(x)


class ReverseFocus(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1, act: str = "silu"):
        super().__init__()
        self.conv = ConvNormAct(in_channels, 4 * out_channels, kernel_size,
                                stride, act=act)

    def forward(self, x):
        y = self.conv(x)
        b, c4, h, w = y.shape
        # channel 4f + g with g = 2j + i for output offset (i, j)
        y = y.reshape(b, c4 // 4, 2, 2, h, w).permute(0, 1, 4, 3, 5, 2)
        return y.reshape(b, c4 // 4, 2 * h, 2 * w)
