"""GFL head (Generalized Focal Loss), the counterpart of
``glsdet_tpu.models.gfl_head`` (reference: mmdet's ``GFLHead`` with its
defaults): 4 stacked 3x3 ConvModules (GroupNorm-32 + ReLU) per tower,
shared across the pyramid levels, a 3x3 class predictor (bias at prior
probability 0.01), a 3x3 box predictor emitting ``4 * (reg_max + 1)``
distribution logits, both with normal(0.01) kernels, and one learnable
``Scale`` per level on the box output.

The head returns raw per-level NHWC maps: the class logits in the
compute dtype and the box distributions in float32; the losses and the
decode live in ``train/gfl_loss.py`` and ``eval/postprocess.py``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from glsdet_tpu_torch.models.layers import (Conv2d, ConvNormAct, Scale, remat,
                                            to_nhwc)

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class GFLHead(nn.Module):
    """With ``remat`` each level's towers are checkpointed in training."""

    def __init__(self, num_classes: int, feat_channels: int = 256,
                 stacked_convs: int = 4, num_levels: int = 5,
                 reg_max: int = 16, remat: bool = False):
        super().__init__()
        fc = feat_channels
        self.num_classes = num_classes
        self.stacked_convs = stacked_convs
        self.num_levels = num_levels
        self.remat = remat
        for i in range(stacked_convs):
            self.add_module(f"cls_conv{i}", ConvNormAct(
                fc, fc, 3, 1, norm="gn", act="relu"))
            self.add_module(f"reg_conv{i}", ConvNormAct(
                fc, fc, 3, 1, norm="gn", act="relu"))
        self.gfl_cls = Conv2d(fc, num_classes, 3, padding=1,
                              kernel_init=0.01, bias_value=PRIOR_BIAS)
        self.gfl_reg = Conv2d(fc, 4 * (reg_max + 1), 3, padding=1,
                              kernel_init=0.01)
        for i in range(num_levels):
            self.add_module(f"scale{i}", Scale(1.0))

    def _level(self, x, lvl: int):
        cls_feat = reg_feat = x
        for i in range(self.stacked_convs):
            cls_feat = getattr(self, f"cls_conv{i}")(cls_feat)
        for i in range(self.stacked_convs):
            reg_feat = getattr(self, f"reg_conv{i}")(reg_feat)
        scale = getattr(self, f"scale{lvl}")
        return (to_nhwc(self.gfl_cls(cls_feat)),
                to_nhwc(scale(self.gfl_reg(reg_feat))).float())

    def forward(self, feats):
        if len(feats) != self.num_levels:
            raise ValueError(f"expected {self.num_levels} levels, got "
                             f"{len(feats)}")
        ckpt = self.remat and self.training and torch.is_grad_enabled()
        cls_scores, bbox_preds = [], []
        for lvl, x in enumerate(feats):
            cs, bp = (remat(self._level, x, lvl) if ckpt
                      else self._level(x, lvl))
            cls_scores.append(cs)
            bbox_preds.append(bp)
        return cls_scores, bbox_preds
