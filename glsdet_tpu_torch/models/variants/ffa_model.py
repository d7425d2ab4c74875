"""The FFA YoloBody, a 4-level YOLOX with a P2 branch and FFA semantic
fusion, the counterpart of ``glsdet_tpu.models.variants.ffa_model``
(NCHW; yolox-drone ``models/ffa/yolox_ffa.py``).

CSPDarknet (out dark2..dark5) -> PAFPN over the three deep levels -> the
stride-4 branch ``p2 = CSP(cat(P2_lat, FFA(P2_lat, P3_out)))`` -> a
4-level YOLOX head at strides (4, 8, 16, 32): 34,000 anchors at 640^2.
"""

from __future__ import annotations

import torch
from torch import nn

from glsdet_tpu_torch.models.csp_darknet import (PHI_TABLE, CSPDarknet,
                                                 scaled_channels,
                                                 scaled_depths)
from glsdet_tpu_torch.models.layers import (ConvNormAct, CSPLayer,
                                            flax_init_, upsample2x)
from glsdet_tpu_torch.models.variants.ffa import FFA
from glsdet_tpu_torch.models.yolox_head import YOLOXHead

FFA_STRIDES = (4, 8, 16, 32)


class FFAYoloBody(nn.Module):
    """4-level FFA model; returns the head's per-level NHWC (cls, reg,
    obj) maps, as ``YOLOXDetector``."""

    def __init__(self, num_classes: int = 10, phi: str = "s", *,
                 generator: torch.Generator):
        super().__init__()
        depth_mult, width_mult, depthwise = PHI_TABLE[phi]
        c = scaled_channels(width_mult)  # (64w, 128w, 256w, 512w, 1024w)
        n = scaled_depths(depth_mult)[0]

        def csp(cin, cout):
            return CSPLayer(cin, cout, num_blocks=n, shortcut=False,
                            depthwise=depthwise)

        self.backbone = CSPDarknet(depth_mult, width_mult, depthwise,
                                   out_indices=(1, 2, 3, 4))
        # top-down (yolox_ffa.py:196-233)
        self.lat0 = ConvNormAct(c[4], c[3], 1, 1)
        self.c3_p4 = csp(2 * c[3], c[3])
        self.reduce1 = ConvNormAct(c[3], c[2], 1, 1)
        self.c3_p3 = csp(2 * c[2], c[2])
        # bottom-up
        self.bu2 = ConvNormAct(c[2], c[2], 3, 2)
        self.c3_n3 = csp(2 * c[2], c[3])
        self.bu1 = ConvNormAct(c[3], c[3], 3, 2)
        self.c3_n4 = csp(2 * c[3], c[4])
        # the P2 branch with FFA fusion (yolox_ffa.py:66-73)
        self.p2_lat = ConvNormAct(c[1], c[1], 1, 1)
        self.ftt = FFA(c[1], c[2])
        self.p2_csp = csp(2 * c[1], c[1])
        self.head = YOLOXHead(num_classes, c[1:5], feat_channels=c[2],
                              depthwise=depthwise)
        flax_init_(self, generator)

    def forward(self, images):
        f0, f1, f2, f3 = self.backbone(images)   # strides 4, 8, 16, 32
        p5 = self.lat0(f3)
        p5_up = self.c3_p4(torch.cat([upsample2x(p5), f2], dim=1))
        p4 = self.reduce1(p5_up)
        p3_out = self.c3_p3(torch.cat([upsample2x(p4), f1], dim=1))
        p4_out = self.c3_n3(torch.cat([self.bu2(p3_out), p4], dim=1))
        p5_out = self.c3_n4(torch.cat([self.bu1(p4_out), p5], dim=1))
        p2_lat = self.p2_lat(f0)
        fused = self.ftt(p2_lat, p3_out)
        p2_out = self.p2_csp(torch.cat([p2_lat, fused], dim=1))
        return self.head((p2_out, p3_out, p4_out, p5_out))
