"""DyHead, the dynamic head over a feature pyramid, the counterpart of
``glsdet_tpu.models.variants.dyhead`` (NCHW; yolox-drone
``models/new/dyhead.py``, ``dyrelu.py``).

Per level one 27-channel offset/mask map from the level itself feeds
three modulated deformable 3x3 convs (+ GroupNorm 16) over the level, the
finer level at stride 2 and the coarser level (then bilinearly upsampled
with aligned corners); each term is gated by h_sigmoid(relu(1x1(GAP))),
the terms are averaged and SiLU'd.  :class:`DyReLU` is the zoo's dynamic
activation.

The deformable conv is a plain gather, as the JAX package's is an XLA
gather: :func:`bilinear_gather` floors float32 coordinates and zeroes
each of the four corners on its own when it falls outside the map
(``modulated_deform_conv2d``'s semantics).  ``F.grid_sample`` normalises
coordinates and rounds differently at the borders, so it is not used;
the aligned-corner upsample goes through the same gather.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from glsdet_tpu_torch.models.layers import Conv2d, Dense

FLAX_GN_EPS = 1e-6


def h_sigmoid(x: torch.Tensor, h_max: float = 1.0) -> torch.Tensor:
    """relu6(x + 3) * h_max / 6 (dyrelu.py:29)."""
    return torch.clamp(x + 3.0, 0.0, 6.0) * (h_max / 6.0)


def bilinear_gather(img: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W); ys, xs (B, ...) float coordinates -> (B, C, ...).
    A corner outside the map reads zero."""
    b, c, h, w = img.shape
    out_shape = ys.shape[1:]
    ys, xs = ys.reshape(b, -1), xs.reshape(b, -1)
    flat = img.reshape(b, c, h * w)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0)[:, None].to(img.dtype)
    wx = (xs - x0)[:, None].to(img.dtype)

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = torch.clamp(yi, 0, h - 1).long()
        xc = torch.clamp(xi, 0, w - 1).long()
        idx = (yc * w + xc)[:, None].expand(b, c, -1)
        return torch.gather(flat, 2, idx) * inside[:, None].to(img.dtype)

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    out = ((v00 * (1 - wx) + v01 * wx) * (1 - wy)
           + (v10 * (1 - wx) + v11 * wx) * wy)
    return out.reshape(b, c, *out_shape)


class DeformConv3x3(nn.Module):
    """Modulated deformable 3x3 conv + GroupNorm(16) (Conv3x3Norm :78).
    ``offsets`` (B, 18, Ho, Wo) and ``masks`` (B, 9, Ho, Wo) come from the
    caller at this conv's output size (input / stride).  The nine taps
    are stacked tap-major (channel k * C + c, k = 3 * (dy + 1) + dx + 1)
    into one 1x1 conv, the JAX package's layout."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 groups: int = 16):
        super().__init__()
        self.stride = stride
        self.add_module("weight", Conv2d(9 * in_channels, out_channels, 1))
        self.gn = nn.GroupNorm(groups, out_channels, eps=FLAX_GN_EPS)

    def forward(self, x, offsets, masks):
        b, _, h, w = x.shape
        s = self.stride
        ho, wo = h // s, w // s
        ys = (torch.arange(ho, device=x.device, dtype=torch.float32)
              * s)[:, None]
        xs = (torch.arange(wo, device=x.device, dtype=torch.float32)
              * s)[None, :]
        offsets = offsets.float()
        taps, k = [], 0
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                sy = ys + dy + offsets[:, 2 * k]
                sx = xs + dx + offsets[:, 2 * k + 1]
                v = bilinear_gather(x, sy, sx)              # (B, C, Ho, Wo)
                taps.append(v * masks[:, k:k + 1].to(x.dtype))
                k += 1
        return self.gn(self.weight(torch.cat(taps, dim=1)))


class DyReLU(nn.Module):
    """Dynamic ReLU (dyrelu.py:39; K2 with bias): pooled context ->
    h_sigmoid(fc) -> (a1, b1, a2, b2); out = max(a1 x + b1, a2 x + b2)."""

    def __init__(self, channels: int, reduction: int = 4,
                 lambda_a: float = 1.0, init_a=(1.0, 0.0), init_b=(0.0, 0.0)):
        super().__init__()
        self.lambda_a, self.init_a, self.init_b = lambda_a, init_a, init_b
        self.fc1 = Dense(channels, max(channels // reduction, 1))
        self.fc2 = Dense(max(channels // reduction, 1), 4 * channels)

    def forward(self, x):
        y = h_sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        a1, b1, a2, b2 = (t[:, :, None, None] for t in y.chunk(4, dim=1))
        la = 2.0 * self.lambda_a
        a1 = (a1 - 0.5) * la + self.init_a[0]
        a2 = (a2 - 0.5) * la + self.init_a[1]
        b1 = (b1 - 0.5) + self.init_b[0]
        b2 = (b2 - 0.5) + self.init_b[1]
        return torch.maximum(a1 * x + b1, a2 * x + b2)


def _upsample_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """``F.upsample_bilinear`` (aligned corners) through the gather."""
    b, _, h, w = x.shape
    ho, wo = hw
    ys = torch.arange(ho, device=x.device, dtype=torch.float32) * (
        (h - 1) / max(ho - 1, 1))
    xs = torch.arange(wo, device=x.device, dtype=torch.float32) * (
        (w - 1) / max(wo - 1, 1))
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return bilinear_gather(x, gy.expand(b, ho, wo), gx.expand(b, ho, wo))


class DyConv(nn.Module):
    """One DyHead stage (dyhead.py:105); its convs are shared by the
    levels."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.offset = Conv2d(c, 27, 3, padding=1)
        self.dconv_cur = DeformConv3x3(c, c, 1)
        self.dconv_fine = DeformConv3x3(c, c, 2)
        self.dconv_coarse = DeformConv3x3(c, c, 1)
        self.attn = Conv2d(c, 1, 1)

    def _gate(self, t):
        return h_sigmoid(F.relu(self.attn(t.mean(dim=(2, 3), keepdim=True))))

    def forward(self, feats: Sequence[torch.Tensor]):
        outs = []
        for lvl, f in enumerate(feats):
            om = self.offset(f)
            offsets, masks = om[:, :18], torch.sigmoid(om[:, 18:])
            terms = [self.dconv_cur(f, offsets, masks)]
            if lvl > 0:
                terms.append(self.dconv_fine(feats[lvl - 1], offsets, masks))
            if lvl < len(feats) - 1:
                up = self.dconv_coarse(feats[lvl + 1], offsets[..., ::2, ::2],
                                       masks[..., ::2, ::2])
                terms.append(_upsample_bilinear(up, f.shape[2:]))
            fused = sum(t * self._gate(t) for t in terms) / len(terms)
            outs.append(F.silu(fused))
        return outs


class DyHead(nn.Module):
    """A stack of DyConv stages (dyhead.py:169; the reference uses 2)."""

    def __init__(self, channels: int, num_stages: int = 2):
        super().__init__()
        self.num_stages = num_stages
        for i in range(num_stages):
            self.add_module(f"stage{i}", DyConv(channels))

    def forward(self, feats: Sequence[torch.Tensor]):
        for i in range(self.num_stages):
            feats = getattr(self, f"stage{i}")(feats)
        return feats
