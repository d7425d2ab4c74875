"""BatchFormer, the batch-axis transformer decorator, the counterpart of
``glsdet_tpu.models.variants.batchformer`` (yolox-drone
``models/batchformer/batchformer.py:3``).

In training, pooled per-sample features pass through one transformer
encoder layer that attends across the batch, and the stream is doubled
(the input unchanged, then the transformed copy) so a shared head sees
both.  Inference returns the input.  The attention follows flax's
``MultiHeadDotProductAttention`` (queries scaled by 1/sqrt(head_dim),
dropout on the attention weights) and the norms flax's ``LayerNorm``
(eps 1e-6).  Dropout draws from the ``generator`` the caller passes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from glsdet_tpu_torch.models.layers import Dense

FLAX_LN_EPS = 1e-6


class MultiHeadDotProductAttention(nn.Module):
    """flax's self-attention layout: ``query``/``key``/``value`` project
    D -> heads * head_dim, ``out`` back to D (flax ``DenseGeneral``
    kernels (D, heads, head_dim) and (heads, head_dim, D) flattened)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(dim, dim))

    def forward(self, x, dropout: float = 0.0,
                generator: Optional[torch.Generator] = None):
        *lead, n, d = x.shape
        h = self.num_heads

        def heads(t):
            return t.reshape(*lead, n, h, d // h).transpose(-3, -2)

        q = heads(self.query(x)) / math.sqrt(d // h)
        k, v = heads(self.key(x)), heads(self.value(x))
        w = torch.softmax(q @ k.transpose(-2, -1), dim=-1)  # (..., h, n, n)
        if dropout > 0.0:
            # one mask for every head (flax's broadcast_dropout)
            keep = torch.rand(w.shape[-2:], generator=generator,
                              device=w.device) >= dropout
            w = w * keep.to(w.dtype) / (1.0 - dropout)
        y = (w @ v).transpose(-3, -2).reshape(*lead, n, d)
        return self.out(y)


class BatchFormer(nn.Module):
    """feature (B, D) -> (2B, D) in training, (B, D) in eval."""

    def __init__(self, dim: int, num_heads: int = 4, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.attn = MultiHeadDotProductAttention(dim, num_heads)
        self.ln1 = nn.LayerNorm(dim, eps=FLAX_LN_EPS)
        self.fc1 = Dense(dim, dim)
        self.fc2 = Dense(dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=FLAX_LN_EPS)

    def forward(self, feature, generator: Optional[torch.Generator] = None):
        if not self.training:
            return feature
        if self.dropout > 0.0 and generator is None:
            raise ValueError("BatchFormer training with dropout needs a "
                             "generator")
        x = feature[None]                       # the batch as one sequence
        x = self.ln1(x + self.attn(x, self.dropout, generator))
        x = self.ln2(x + self.fc2(F.relu(self.fc1(x))))[0]
        return torch.cat([feature, x], dim=0)


class BatchFormerV2(nn.Module):
    """The spatial variant (batchformerv2.py:4): GAP of a (B, C, H, W)
    map, a projection to ``dim``, then :class:`BatchFormer` in training
    ((2B, dim)); eval returns the projection."""

    def __init__(self, in_channels: int, dim: int, num_heads: int = 4,
                 dropout: float = 0.5):
        super().__init__()
        self.pool_proj = Dense(in_channels, dim)
        self.bf = BatchFormer(dim, num_heads, dropout)

    def forward(self, feature, generator: Optional[torch.Generator] = None):
        pooled = self.pool_proj(feature.mean(dim=(2, 3)))
        if not self.training:
            return pooled
        return self.bf(pooled, generator)
