"""Neck variants, the counterparts of ``glsdet_tpu.models.variants.necks``
(NCHW).

- :class:`FeatureGroupFPN`: each level's channels split into groups, a
  3x3 ConvNormAct per group, concatenated; ``cascade`` stacks two rounds.
- :func:`cross_scale_concat`: the cls-branch fusion of the JAX "yolox6"
  head; no configuration builds that head yet.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from glsdet_tpu_torch.models.layers import ConvNormAct, upsample2x


class FeatureGroup(nn.Module):
    """Per-group 3x3 convs over channel splits of one level."""

    def __init__(self, channels: int, groups: int = 4):
        super().__init__()
        self.groups = groups
        self.gs = gs = channels // groups
        for g in range(groups):
            self.add_module(f"g{g}", ConvNormAct(gs, gs, 3, 1, act="silu"))

    def forward(self, x):
        gs = self.gs
        return torch.cat([getattr(self, f"g{g}")(x[:, g * gs:(g + 1) * gs])
                          for g in range(self.groups)], dim=1)


class FeatureGroupFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], groups: int = 4,
                 cascade: bool = False):
        super().__init__()
        self.rounds = 2 if cascade else 1
        self.num_levels = len(in_channels)
        for r in range(self.rounds):
            for i, c in enumerate(in_channels):
                # a level's width is groups * (c // groups) after a round
                c_in = c if r == 0 else groups * (c // groups)
                self.add_module(f"r{r}_l{i}", FeatureGroup(c_in, groups))

    def forward(self, feats):
        feats = list(feats)
        for r in range(self.rounds):
            feats = [getattr(self, f"r{r}_l{i}")(f)
                     for i, f in enumerate(feats)]
        return tuple(feats)


def cross_scale_concat(feats: Sequence[torch.Tensor],
                       lvl: int) -> torch.Tensor:
    """[current, finer max-pooled 2x2/2, coarser nearest-upsampled 2x]
    along channels; the missing neighbour is skipped at either end.  The
    pool floors odd sizes, as the JAX package's VALID reduce_window."""
    parts: List[torch.Tensor] = [feats[lvl]]
    if lvl > 0:
        parts.append(F.max_pool2d(feats[lvl - 1], 2, 2))
    if lvl < len(feats) - 1:
        parts.append(upsample2x(feats[lvl + 1]))
    return torch.cat(parts, dim=1)
