"""LSK, large selective kernel spatial attention, the counterpart of
``glsdet_tpu.models.variants.lsk`` (NCHW; LSK.py:27,54 of yolox-drone).

:class:`LSKBlock`: a 5x5 depthwise conv, then a 7x7 depthwise conv at
dilation 3; each 1x1-reduced to C/2; their channel mean and max through a
7x7 conv to two sigmoid gates; the gated mix 1x1 back to C multiplies the
input.  :class:`LSKAttention`: 1x1 -> GELU (tanh form, ``jax.nn.gelu``'s
default) -> LSK -> 1x1 + residual.  The coarse detector's ``lsk`` variant
puts one after each backbone output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from glsdet_tpu_torch.models.layers import Conv2d


class LSKBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.conv0 = Conv2d(c, c, 5, padding=2, groups=c)
        self.conv_spatial = Conv2d(c, c, 7, padding=9, groups=c, dilation=3)
        self.conv1 = Conv2d(c, c // 2, 1)
        self.conv2 = Conv2d(c, c // 2, 1)
        self.conv_squeeze = Conv2d(2, 2, 7, padding=3)
        self.conv = Conv2d(c // 2, c, 1)

    def forward(self, x):
        a1 = self.conv0(x)
        a2 = self.conv_spatial(a1)
        a1 = self.conv1(a1)
        a2 = self.conv2(a2)
        attn = torch.cat([a1, a2], dim=1)
        agg = torch.cat([attn.mean(dim=1, keepdim=True),
                         attn.amax(dim=1, keepdim=True)], dim=1)
        sig = torch.sigmoid(self.conv_squeeze(agg))
        mixed = a1 * sig[:, 0:1] + a2 * sig[:, 1:2]
        return x * self.conv(mixed)


class LSKAttention(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.proj1 = Conv2d(channels, channels, 1)
        self.lsk = LSKBlock(channels)
        self.proj2 = Conv2d(channels, channels, 1)

    def forward(self, x):
        y = F.gelu(self.proj1(x), approximate="tanh")
        return x + self.proj2(self.lsk(y))
