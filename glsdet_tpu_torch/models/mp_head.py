"""MPHead, the multi-proxy head, counterpart of ``glsdet_tpu.models.mp_head``.

A GFL head whose class predictor is cosine classification against
learnable per-class proxies: class score = gamma * sum_p softmax_p(gamma *
sim) * sim over the class's proxies, computed as two matmuls with a
proxy-to-class membership matrix.  In training mode the head returns the
raw class features instead: the MP-Det loss (``train/mp_loss.py``)
scores them itself and also feeds them to the BoIW and OT losses.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from glsdet_tpu_torch.models.layers import (Conv2d, ConvNormAct, Scale, remat,
                                             to_nhwc)

VISDRONE_PROXIES = (2, 3, 2, 5, 4, 8, 8, 4, 3, 3)


def proxy_class_matrix(proxies_list: Sequence[int]) -> np.ndarray:
    """(num_proxies, num_classes) one-hot membership matrix."""
    mat = np.zeros((sum(proxies_list), len(proxies_list)), np.float32)
    start = 0
    for c, n in enumerate(proxies_list):
        mat[start:start + n, c] = 1.0
        start += n
    return mat


def proxy_scores(feat, proxies, membership, gamma: float = 10.0,
                 return_sim: bool = False):
    """(N, C) features, (P, C) proxies, (P, classes) membership ->
    (N, classes) pre-sigmoid scores; with ``return_sim`` also the (N, P)
    cosine similarities."""
    f = feat * torch.rsqrt((feat * feat).sum(-1, keepdim=True) + 1e-12)
    p = proxies * torch.rsqrt(
        (proxies * proxies).sum(-1, keepdim=True) + 1e-12)
    sim = f @ p.T
    # gamma * sim <= gamma, so a plain exp is safe (gamma = 10)
    e = torch.exp(gamma * sim)
    denom = e @ membership
    num = (e * sim) @ membership
    scores = gamma * num / torch.clamp(denom, min=1e-12)
    if return_sim:
        return scores, sim
    return scores


class MPHead(nn.Module):
    """GFL-structured head with the proxy classifier.  Towers are shared
    across levels.  Returns per-level NHWC maps: class scores (float32;
    in training mode the raw class features, in the compute dtype) and
    the (4 * (reg_max + 1)) box distributions (float32).  With ``remat``
    each level's towers are checkpointed in training."""

    def __init__(self, num_classes: int = 10, feat_channels: int = 256,
                 stacked_convs: int = 4, num_levels: int = 5,
                 reg_max: int = 16, gamma: float = 10.0,
                 proxies_list: Sequence[int] = VISDRONE_PROXIES,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        if num_classes != len(proxies_list):
            raise ValueError("num_classes must equal len(proxies_list)")
        fc = feat_channels
        self.stacked_convs = stacked_convs
        self.num_levels = num_levels
        self.gamma = gamma
        self.num_classes = num_classes
        for i in range(stacked_convs):
            self.add_module(f"cls_conv{i}", ConvNormAct(
                fc, fc, 3, 1, norm="gn", act="relu"))
            self.add_module(f"reg_conv{i}", ConvNormAct(
                fc, fc, 3, 1, norm="gn", act="relu"))
        self.gfl_cls_conv = Conv2d(fc, fc, 3, padding=1, kernel_init=0.01)
        self.gfl_reg = Conv2d(fc, 4 * (reg_max + 1), 3, padding=1,
                              kernel_init=0.01)
        for i in range(num_levels):
            self.add_module(f"scale{i}", Scale(1.0))
        self.proxies = nn.Parameter(torch.empty(sum(proxies_list), fc))
        self.register_buffer(
            "membership", torch.from_numpy(proxy_class_matrix(proxies_list)),
            persistent=False)

    def flax_init(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.proxies, 0.0, 0.01, generator=generator)

    def _level(self, x, lvl: int):
        cls_feat = reg_feat = x
        for i in range(self.stacked_convs):
            cls_feat = getattr(self, f"cls_conv{i}")(cls_feat)
            reg_feat = getattr(self, f"reg_conv{i}")(reg_feat)
        scale = getattr(self, f"scale{lvl}")
        return (to_nhwc(self.gfl_cls_conv(cls_feat)),
                to_nhwc(scale(self.gfl_reg(reg_feat))).float())

    def forward(self, feats):
        ckpt = self.remat and self.training and torch.is_grad_enabled()
        cls_out, bbox_preds = [], []
        for lvl, x in enumerate(feats):
            cls_feat, bbox_pred = (remat(self._level, x, lvl) if ckpt
                                   else self._level(x, lvl))
            bbox_preds.append(bbox_pred)
            if self.training:
                cls_out.append(cls_feat)
                continue
            b, h, w, c = cls_feat.shape
            scores = proxy_scores(cls_feat.reshape(-1, c).float(),
                                  self.proxies.float(),
                                  self.membership.float(), self.gamma)
            cls_out.append(scores.reshape(b, h, w, self.num_classes))
        return cls_out, bbox_preds
