"""Detector assemblies, the counterparts of ``glsdet_tpu.models.detectors``.

- ``YOLOXDetector``: CSPDarknet -> PAFPN -> decoupled head (the coarse
  detector of the two-stage path), with the zoo's ``variant`` plugins.
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

from glsdet_tpu_torch.models import variants as v
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

# YOLOX variants with one module per level: (name prefix, module of width)
_PER_LEVEL = {"lsk": ("lsk", v.LSKAttention), "se": ("se", v.SEBlock),
              "mscam": ("mscam", v.MSCAM),
              "nonlocal": ("nl", lambda c: v.PatchNonLocal(c, patch=4))}


class YOLOXDetector(nn.Module):
    """YOLOX coarse detector; ``phi`` selects width and depth.

    ``variant`` plugs in a module of the zoo (``models/variants``), named
    as the JAX package names it:

    - ``"lsk"``: ``LSKAttention`` after each backbone output (``lsk{i}``);
    - ``"evc"``: ``EVCBlock`` on the deepest backbone output (``evc``);
    - ``"se"`` / ``"mscam"`` / ``"nonlocal"``: ``SEBlock`` /
      ``MSCAM`` / ``PatchNonLocal(patch=4)`` on each neck output
      (``se{i}``, ``mscam{i}``, ``nl{i}``);
    - ``"fg_fpn"``: ``FeatureGroupFPN`` after the neck (``fg_fpn``).

    Any other string builds the plain detector, as in the JAX package."""

    def __init__(self, num_classes: int = 10, phi: str = "s",
                 variant: str = "", *, generator: torch.Generator):
        super().__init__()
        depth_mult, width_mult, depthwise = PHI_TABLE[phi]
        chans = scaled_channels(width_mult)
        levels = chans[2:5]
        self.variant = variant
        self.backbone = CSPDarknet(depth_mult, width_mult, depthwise)
        if variant in _PER_LEVEL:
            prefix, make = _PER_LEVEL[variant]
            for i, c in enumerate(levels):
                self.add_module(f"{prefix}{i}", make(c))
        elif variant == "evc":
            self.evc = v.EVCBlock(levels[-1])
        elif variant == "fg_fpn":
            self.fg_fpn = v.FeatureGroupFPN(levels)
        self.neck = YOLOXPAFPN(levels, scaled_depths(depth_mult)[0],
                               depthwise)
        self.head = YOLOXHead(num_classes, levels,
                              feat_channels=chans[2], depthwise=depthwise)
        flax_init_(self, generator)

    def _each_level(self, feats):
        prefix = _PER_LEVEL[self.variant][0]
        return tuple(getattr(self, f"{prefix}{i}")(f)
                     for i, f in enumerate(feats))

    def forward(self, images):
        feats = self.backbone(images)
        if self.variant == "lsk":
            feats = self._each_level(feats)
        elif self.variant == "evc":
            feats = (*feats[:-1], self.evc(feats[-1]))
        feats = self.neck(feats)
        if self.variant in ("se", "mscam", "nonlocal"):
            feats = self._each_level(feats)
        elif self.variant == "fg_fpn":
            feats = self.fg_fpn(feats)
        return self.head(feats)


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
