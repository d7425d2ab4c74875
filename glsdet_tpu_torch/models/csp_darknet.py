"""CSPDarknet backbone (YOLOX), the counterpart of ``glsdet_tpu.models.csp_darknet``.

Stages (base widths; depth = round(3 * depth_mult) except stage 1):
    stem  Focus  -> 64w
    dark2 conv/2 -> 128w, CSP(n)
    dark3 conv/2 -> 256w, CSP(3n)   -> out P3 (stride 8)
    dark4 conv/2 -> 512w, CSP(3n)   -> out P4 (stride 16)
    dark5 conv/2 -> 1024w, SPP, CSP(n, no shortcut) -> out P5 (stride 32)
"""

from __future__ import annotations

from typing import Sequence, Tuple

from torch import nn

from glsdet_tpu_torch.models.layers import (ConvNormAct, CSPLayer,
                                            DWConvBlock, Focus,
                                            SPPBottleneck)

# phi -> (depth_mult, width_mult, depthwise)
PHI_TABLE = {
    "nano": (0.33, 0.25, True),
    "tiny": (0.33, 0.375, False),
    "s": (0.33, 0.50, False),
    "m": (0.67, 0.75, False),
    "l": (1.0, 1.0, False),
    "x": (1.33, 1.25, False),
}

BASE_CHANNELS = (64, 128, 256, 512, 1024)
BASE_DEPTHS = (3, 9, 9, 3)


def scaled_channels(width_mult: float) -> Tuple[int, ...]:
    return tuple(int(c * width_mult) for c in BASE_CHANNELS)


def scaled_depths(depth_mult: float) -> Tuple[int, ...]:
    return tuple(max(round(d * depth_mult), 1) for d in BASE_DEPTHS)


class CSPDarknet(nn.Module):
    """YOLOX backbone; returns the features of ``out_indices`` over (stem
    0, dark2 1, dark3 2, dark4 3, dark5 4), by default (P3, P4, P5)."""

    def __init__(self, depth_mult: float = 0.33, width_mult: float = 0.50,
                 depthwise: bool = False, act: str = "silu",
                 out_indices: Sequence[int] = (2, 3, 4)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        chans = scaled_channels(width_mult)
        depths = scaled_depths(depth_mult)
        self.stem = Focus(3, chans[0], 3, act=act)
        for i, (c, n) in enumerate(zip(chans[1:], depths)):
            stage = i + 2                       # dark2..dark5
            last = stage == 5
            cin = chans[i]
            down = (DWConvBlock(cin, c, 3, 2, act=act) if depthwise
                    else ConvNormAct(cin, c, 3, 2, act=act))
            self.add_module(f"dark{stage}_down", down)
            if last:
                self.spp = SPPBottleneck(c, c, act=act)
            self.add_module(f"dark{stage}_csp", CSPLayer(
                c, c, num_blocks=depths[0] if last else n,
                shortcut=not last, depthwise=depthwise, act=act))

    def forward(self, x):
        x = self.stem(x)
        outs = [x] if 0 in self.out_indices else []
        for stage in (2, 3, 4, 5):
            x = getattr(self, f"dark{stage}_down")(x)
            if stage == 5:
                x = self.spp(x)
            x = getattr(self, f"dark{stage}_csp")(x)
            if stage - 1 in self.out_indices:
                outs.append(x)
        return tuple(outs)
