"""FFA, the feature fusion attention block (the global-local feature-level
fusion of ``yolox-drone/models/ffa/ffa.py:22``), the counterpart of
``glsdet_tpu.models.variants.ffa`` (NCHW).

The low-resolution "top" feature is expanded 1x1 to 4C, passed through
two 1x1 content convs with an SE-gated residual, and pixel-shuffled to C
channels at twice the resolution; concatenated with the "bottom" feature
it goes through a 1x1 texture conv and a 1x1 reduce to C; the output is
the shuffled top plus the fused bottom.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from glsdet_tpu_torch.models.layers import ConvNormAct
from glsdet_tpu_torch.models.variants.attention import SE


def pixel_shuffle_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, 4C, H, W) -> (B, C, 2H, 2W), channel-major:
    out[c, 2h+i, 2w+j] = in[4c + 2i + j, h, w] (the JAX package's NHWC
    ``pixel_shuffle_2x``, which matches ``nn.PixelShuffle``)."""
    return F.pixel_shuffle(x, 2)


class FFA(nn.Module):
    """fuse(bottom: C channels at 2x resolution, top: ``top_channels`` at
    1x) -> C channels at 2x."""

    def __init__(self, channels: int, top_channels: int, act: str = "relu"):
        super().__init__()
        c = channels
        self.scale = ConvNormAct(top_channels, 4 * c, 1, 1, act=act)
        self.content1 = ConvNormAct(4 * c, 4 * c, 1, 1, act=act)
        self.content2 = ConvNormAct(4 * c, 4 * c, 1, 1, act=act)
        self.se = SE(4 * c)
        self.texture = ConvNormAct(2 * c, 2 * c, 1, 1, act=act)
        self.reduce = ConvNormAct(2 * c, c, 1, 1, act=act)

    def forward(self, bottom, top):
        t = self.content2(self.content1(self.scale(top)))
        t = pixel_shuffle_2x(t + self.se(t))
        btm = self.reduce(self.texture(torch.cat([bottom, t], dim=1)))
        return t + btm
