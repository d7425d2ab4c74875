"""CFP / EVC, the centralized feature pyramid blocks, the counterparts of
``glsdet_tpu.models.variants.cfp`` (NCHW; CFP, arXiv:2210.02093).

- :class:`LVCBlock`: a learnable visual centre.  Each pixel feature is
  soft-assigned to K codewords by softplus-scaled squared distances, the
  residuals are aggregated per codeword, and their ReLU sum gates the
  channels.  The codebook arithmetic runs in float32 whatever the
  surrounding dtype or autocast, as XLA keeps it.
- :class:`LightMLPBlock`: a depthwise 3x3 token mixer and a channel MLP,
  each behind GroupNorm(1) (flax's eps 1e-6) and a layer scale.
- :class:`EVCBlock`: a 3x3 stem, both branches, concatenated, fused 1x1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from glsdet_tpu_torch.models.layers import Conv2d, ConvNormAct, Dense

FLAX_GN_EPS = 1e-6


class LVCBlock(nn.Module):
    def __init__(self, channels: int, num_codes: int = 64):
        super().__init__()
        self.proj = ConvNormAct(channels, channels, 1, 1, act="relu")
        self.codebook = nn.Parameter(torch.empty(num_codes, channels))
        self.smooth = nn.Parameter(torch.ones(num_codes))
        self.fc = Dense(channels, channels)

    def flax_init(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.codebook, 0.0, 0.02, generator=generator)
        self.smooth.fill_(1.0)

    def forward(self, x):
        b, c, h, w = x.shape
        f = self.proj(x)
        with torch.autocast(x.device.type, enabled=False):
            feats = f.float().reshape(b, c, h * w).transpose(1, 2)
            code = self.codebook.float()
            x2 = (feats * feats).sum(-1, keepdim=True)           # (B, N, 1)
            c2 = (code * code).sum(-1)                           # (K,)
            dist2 = x2 - 2 * (feats @ code.t()) + c2
            logits = -F.softplus(self.smooth.float()) * dist2
            assign = torch.softmax(logits, dim=-1)               # (B, N, K)
            agg_x = torch.einsum("bnk,bnc->bkc", assign, feats)
            agg_c = assign.sum(1)[..., None] * code[None]
            e = F.relu(agg_x - agg_c).sum(1)                     # (B, C)
        gate = torch.sigmoid(self.fc(e.to(x.dtype)))
        return x + x * gate[:, :, None, None]


class LightMLPBlock(nn.Module):
    def __init__(self, channels: int, mlp_ratio: float = 4.0):
        super().__init__()
        c = channels
        self.ls1 = nn.Parameter(torch.full((c,), 1e-2))
        self.ls2 = nn.Parameter(torch.full((c,), 1e-2))
        self.norm1 = nn.GroupNorm(1, c, eps=FLAX_GN_EPS)
        self.dw = Conv2d(c, c, 3, padding=1, groups=c)
        self.norm2 = nn.GroupNorm(1, c, eps=FLAX_GN_EPS)
        self.fc1 = Conv2d(c, int(c * mlp_ratio), 1)
        self.fc2 = Conv2d(int(c * mlp_ratio), c, 1)

    def flax_init(self, generator: torch.Generator) -> None:
        self.ls1.fill_(1e-2)
        self.ls2.fill_(1e-2)

    def forward(self, x):
        x = x + self.ls1.to(x.dtype)[:, None, None] * self.dw(self.norm1(x))
        y = F.gelu(self.fc1(self.norm2(x)), approximate="tanh")
        return x + self.ls2.to(x.dtype)[:, None, None] * self.fc2(y)


class EVCBlock(nn.Module):
    def __init__(self, channels: int, num_codes: int = 64):
        super().__init__()
        self.stem = ConvNormAct(channels, channels, 3, 1, act="silu")
        self.lvc = LVCBlock(channels, num_codes)
        self.mlp = LightMLPBlock(channels)
        self.fuse = Conv2d(2 * channels, channels, 1)

    def forward(self, x):
        stem = self.stem(x)
        return self.fuse(torch.cat([self.lvc(stem), self.mlp(stem)], dim=1))
