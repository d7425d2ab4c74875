"""Detector assemblies, the counterparts of ``glsdet_tpu.models.detectors``.

- ``YOLOXDetector``: CSPDarknet -> PAFPN -> decoupled head (the coarse
  detector of the two-stage path; no attention variants yet).
- ``MPDet``: ResNet -> FPN (5 levels) -> MPHead.
- ``GFLDet``: ResNet -> FPN (5 levels) -> GFLHead (the plain GFL
  single-stage detector, MP-Det's ablation baseline).

All take NCHW images and return the head's per-level NHWC maps, and
all are initialised from an explicit ``torch.Generator`` with the JAX
package's initializers.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from glsdet_tpu_torch.models.csp_darknet import (PHI_TABLE, CSPDarknet,
                                                 scaled_channels,
                                                 scaled_depths)
from glsdet_tpu_torch.models.fpn import FPN
from glsdet_tpu_torch.models.gfl_head import GFLHead
from glsdet_tpu_torch.models.layers import flax_init_
from glsdet_tpu_torch.models.mp_head import VISDRONE_PROXIES, MPHead
from glsdet_tpu_torch.models.pafpn import YOLOXPAFPN
from glsdet_tpu_torch.models.resnet import ResNet
from glsdet_tpu_torch.models.yolox_head import YOLOXHead

YOLOX_STRIDES = (8, 16, 32)
GFL_STRIDES = (8, 16, 32, 64, 128)


class YOLOXDetector(nn.Module):
    """YOLOX coarse detector; ``phi`` selects width and depth."""

    def __init__(self, num_classes: int = 10, phi: str = "s", *,
                 generator: torch.Generator):
        super().__init__()
        depth_mult, width_mult, depthwise = PHI_TABLE[phi]
        chans = scaled_channels(width_mult)
        self.backbone = CSPDarknet(depth_mult, width_mult, depthwise)
        self.neck = YOLOXPAFPN(chans[2:5], scaled_depths(depth_mult)[0],
                               depthwise)
        self.head = YOLOXHead(num_classes, chans[2:5],
                              feat_channels=chans[2], depthwise=depthwise)
        flax_init_(self, generator)

    def forward(self, images):
        return self.head(self.neck(self.backbone(images)))


class MPDet(nn.Module):
    """MP-Det: ResNet + FPN + MPHead (the mp_det_res50 configuration).
    In training mode the head returns raw class features; ``remat``
    checkpoints the ResNet blocks and each level's head towers there, as
    the JAX package's ``nn.remat`` does."""

    def __init__(self, num_classes: int = 10, depth: int = 50,
                 feat_channels: int = 256,
                 proxies_list: Sequence[int] = VISDRONE_PROXIES,
                 gamma: float = 10.0, remat: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.backbone = ResNet(depth, remat=remat)
        self.neck = FPN(self.backbone.out_channels[1:], feat_channels, 5)
        self.head = MPHead(num_classes, feat_channels,
                           proxies_list=tuple(proxies_list), gamma=gamma,
                           remat=remat)
        flax_init_(self, generator)

    def forward(self, images):
        feats = self.backbone(images)[1:]       # FPN start_level=1
        return self.head(self.neck(feats))


class GFLDet(nn.Module):
    """ResNet + FPN + GFLHead (the gfl_res50 configuration); ``remat``
    checkpoints the ResNet blocks and each level's head towers in
    training, as MPDet's does."""

    def __init__(self, num_classes: int = 10, depth: int = 50,
                 feat_channels: int = 256, remat: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.backbone = ResNet(depth, remat=remat)
        self.neck = FPN(self.backbone.out_channels[1:], feat_channels, 5)
        self.head = GFLHead(num_classes, feat_channels, remat=remat)
        flax_init_(self, generator)

    def forward(self, images):
        feats = self.backbone(images)[1:]       # FPN start_level=1
        return self.head(self.neck(feats))
