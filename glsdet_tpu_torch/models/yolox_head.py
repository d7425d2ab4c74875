"""YOLOX decoupled head + grid decode, the counterpart of
``glsdet_tpu.models.yolox_head``.

    cx = (grid_x + pred_x) * stride        w = exp(pred_w) * stride
    cy = (grid_y + pred_y) * stride        h = exp(pred_h) * stride
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from glsdet_tpu_torch.models.layers import (Conv2d, ConvNormAct,
                                            DWConvBlock, to_nhwc)

# prior-prob 0.01 bias on the cls/obj logits (reference init_weights)
PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class YOLOXHead(nn.Module):
    """Decoupled YOLOX head over N pyramid levels, separate towers per
    level.  Returns per-level NHWC maps: cls (num_classes), reg (4),
    obj (1), the layout of the JAX package."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 feat_channels: int = 128, stacked_convs: int = 2,
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        self.num_levels = len(in_channels)
        self.stacked_convs = stacked_convs
        blk = DWConvBlock if depthwise else ConvNormAct
        fc = feat_channels
        for lvl, cin in enumerate(in_channels):
            self.add_module(f"stem{lvl}", ConvNormAct(cin, fc, 1, 1, act=act))
            for i in range(stacked_convs):
                self.add_module(f"cls{lvl}_{i}", blk(fc, fc, 3, 1, act=act))
                self.add_module(f"reg{lvl}_{i}", blk(fc, fc, 3, 1, act=act))
            self.add_module(f"cls_pred{lvl}", Conv2d(
                fc, num_classes, 1, bias_value=PRIOR_BIAS))
            self.add_module(f"reg_pred{lvl}", Conv2d(fc, 4, 1))
            self.add_module(f"obj_pred{lvl}", Conv2d(
                fc, 1, 1, bias_value=PRIOR_BIAS))

    def forward(self, feats):
        cls_out, reg_out, obj_out = [], [], []
        for lvl, x in enumerate(feats):
            x = getattr(self, f"stem{lvl}")(x)
            cls_feat = reg_feat = x
            for i in range(self.stacked_convs):
                cls_feat = getattr(self, f"cls{lvl}_{i}")(cls_feat)
                reg_feat = getattr(self, f"reg{lvl}_{i}")(reg_feat)
            cls_out.append(to_nhwc(getattr(self, f"cls_pred{lvl}")(cls_feat)))
            reg_out.append(to_nhwc(getattr(self, f"reg_pred{lvl}")(reg_feat)))
            obj_out.append(to_nhwc(getattr(self, f"obj_pred{lvl}")(reg_feat)))
        return cls_out, reg_out, obj_out


def level_priors(featmap_sizes: Sequence[Tuple[int, int]],
                 strides: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Flattened per-anchor grid coordinates and strides (mmdet's
    MlvlPointGenerator): (A, 2) float32 grid (x, y) in units of stride,
    offset 0, and (A,) float32 strides, levels concatenated in order."""
    grids, strs = [], []
    for (h, w), s in zip(featmap_sizes, strides):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        grids.append(np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1))
        strs.append(np.full((h * w,), s))
    return (np.concatenate(grids, axis=0).astype(np.float32),
            np.concatenate(strs, axis=0).astype(np.float32))


def flatten_head_outputs(cls_out, reg_out, obj_out):
    """Per-level NHWC maps -> (B, A, C), (B, A, 4), (B, A) flat tensors."""
    b = cls_out[0].shape[0]
    cls_flat = torch.cat([c.reshape(b, -1, c.shape[-1]) for c in cls_out], 1)
    reg_flat = torch.cat([r.reshape(b, -1, 4) for r in reg_out], 1)
    obj_flat = torch.cat([o.reshape(b, -1) for o in obj_out], 1)
    return cls_flat, reg_flat, obj_flat


def decode_boxes(reg_flat, grids, strides):
    """YOLOX decode to xyxy. reg_flat (B, A, 4); grids (A, 2); strides (A,)."""
    xy = (reg_flat[..., :2] + grids) * strides[:, None]
    wh = torch.exp(reg_flat[..., 2:4]) * strides[:, None]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
