"""Attention blocks of the yolox-drone zoo, the counterparts of
``glsdet_tpu.models.variants.attention`` (NCHW).

Each takes its input width at construction, where the flax module infers
it.  Parameter names are the flax scopes (``fc1``, ``local_bn1``,
``nl_lt``, ...), so ``utils/flax_import.py`` carries the JAX package's
variables across.

- SE family: :class:`SE` (avg-pool gate), :class:`SEBlock` (avg + max),
  :class:`SEBlockFPN` (one gate over every level), :class:`SEAttention`
  (a gate over the H*W positions; only well formed when H*W equals its
  ``channels``).
- :class:`MSCAM`: local + global 1x1/BN branches, summed, sigmoid gate
  (BN eps 1e-5, the reference's torch default).
- :class:`ConAugModule`: 3x3 convs at dilation 1, 2, 3, concatenated.
- Non-local family: :class:`NonLocalBlock` ("dot": theta phi^T / HW with
  no softmax, the reference's path; "gaussian": softmax), patch and
  quadrant variants, :class:`VANAttention`, :class:`SpatialAttention`
  (CBAM) and :class:`PatchConvNonLocalAdapt`, the fixed-shape re-design
  that rolls the map so the activation-mass centroid lands on the half
  boundary.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from glsdet_tpu_torch.models.layers import (BN_MOMENTUM, BatchNorm2d, Conv2d,
                                            ConvNormAct, Dense)


class SE(nn.Module):
    """Squeeze-excitation gate (ffa.py:5), reduction 16."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Dense(channels, max(channels // reduction, 1), bias=False)
        self.fc2 = Dense(max(channels // reduction, 1), channels, bias=False)

    def forward(self, x):
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * y[:, :, None, None]


class SEBlock(nn.Module):
    """avg + max squeeze through one MLP (SEBlock.py:5), reduction 4."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.fc1 = Dense(channels, max(channels // reduction, 1), bias=False)
        self.fc2 = Dense(max(channels // reduction, 1), channels, bias=False)

    def forward(self, x):
        avg = F.relu(self.fc1(x.mean(dim=(2, 3))))
        mx = F.relu(self.fc1(x.amax(dim=(2, 3))))
        return x * torch.sigmoid(self.fc2(avg + mx))[:, :, None, None]


class SEBlockFPN(nn.Module):
    """One SE gate over every level's pooled channels (SEBlock.py:36),
    reduction 8."""

    def __init__(self, in_channels: Sequence[int], reduction: int = 8):
        super().__init__()
        self.in_channels = tuple(in_channels)
        c = sum(self.in_channels)
        self.fc1 = Dense(c, max(c // reduction, 1), bias=False)
        self.fc2 = Dense(max(c // reduction, 1), c, bias=False)

    def forward(self, feats):
        pooled = torch.cat([f.mean(dim=(2, 3)) for f in feats], dim=1)
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(pooled))))
        gates = torch.split(y, self.in_channels, dim=1)
        return [f * g[:, :, None, None] for f, g in zip(feats, gates)]


class SEAttention(nn.Module):
    """SE over the flattened positions (SEBlock.py:74): each position's
    channel mean, gated by an MLP sized by ``channels``; the input must
    have H*W == ``channels``."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.channels = channels
        self.fc1 = Dense(channels, max(channels // reduction, 1), bias=False)
        self.fc2 = Dense(max(channels // reduction, 1), channels, bias=False)

    def forward(self, x):
        b, _, h, w = x.shape
        if h * w != self.channels:
            raise ValueError(
                f"SEAttention: H*W ({h * w}) must equal channels "
                f"({self.channels}) — SEBlock.py:74 semantics")
        n = x.mean(dim=1).reshape(b, h * w)
        n = torch.sigmoid(self.fc2(F.relu(self.fc1(n))))
        return x * n.reshape(b, 1, h, w)


class MSCAM(nn.Module):
    """Multi-scale channel attention (mscam.py:5), r = 4, BN eps 1e-5."""

    def __init__(self, channels: int, reduction: int = 4, eps: float = 1e-5):
        super().__init__()
        inter = max(channels // reduction, 1)
        for p in ("local", "global"):
            self.add_module(f"{p}_conv1", Conv2d(channels, inter, 1))
            self.add_module(f"{p}_bn1", BatchNorm2d(inter, eps=eps,
                                                    momentum=BN_MOMENTUM))
            self.add_module(f"{p}_conv2", Conv2d(inter, channels, 1))
            self.add_module(f"{p}_bn2", BatchNorm2d(channels, eps=eps,
                                                    momentum=BN_MOMENTUM))

    def _branch(self, x, p):
        y = F.relu(getattr(self, f"{p}_bn1")(getattr(self, f"{p}_conv1")(x)))
        return getattr(self, f"{p}_bn2")(getattr(self, f"{p}_conv2")(y))

    def forward(self, x):
        local = self._branch(x, "local")
        glob = self._branch(x.mean(dim=(2, 3), keepdim=True), "global")
        return x * torch.sigmoid(local + glob)


class ConAugModule(nn.Module):
    """Parallel 3x3 convs at dilation 1, 2, 3, concatenated (CAM.py:5)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        for d in (1, 2, 3):
            self.add_module(f"conv_d{d}", Conv2d(
                in_channels, out_channels, 3, padding=d, dilation=d))

    def forward(self, x):
        return torch.cat([getattr(self, f"conv_d{d}")(x) for d in (1, 2, 3)],
                         dim=1)


class NonLocalBlock(nn.Module):
    """Non-local attention (Non_local_family.py:6): theta/phi/g 1x1 at
    ``inter_channels`` (C/2 by default), one (HW, HW) product, 1x1 out
    and the residual.  ``mode="dot"`` divides the logits by HW and takes
    no softmax (the reference's forward); ``"gaussian"`` is the softmax
    over logits / sqrt(inter)."""

    def __init__(self, channels: int, mode: str = "dot",
                 inter_channels: Optional[int] = None):
        super().__init__()
        self.mode = mode
        inter = inter_channels or max(channels // 2, 1)
        self.theta = Conv2d(channels, inter, 1)
        self.phi = Conv2d(channels, inter, 1)
        self.g = Conv2d(channels, inter, 1)
        self.out = Conv2d(inter, channels, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        q = self.theta(x).flatten(2).transpose(1, 2)        # (B, HW, I)
        k = self.phi(x).flatten(2).transpose(1, 2)
        v = self.g(x).flatten(2)                            # (B, I, HW)
        logits = q @ k.transpose(1, 2)                      # (B, HW, HW)
        if self.mode == "dot":
            attn = logits / (h * w)
        else:
            attn = torch.softmax(logits / math.sqrt(q.shape[-1]), dim=-1)
        y = (v @ attn.transpose(1, 2)).reshape(b, -1, h, w)
        return x + self.out(y)


class PatchNonLocal(nn.Module):
    """:class:`NonLocalBlock` over non-overlapping ``patch`` x ``patch``
    windows (weights shared by the windows)."""

    def __init__(self, channels: int, patch: int = 8):
        super().__init__()
        self.patch = patch
        self.nl = NonLocalBlock(channels)

    def forward(self, x):
        b, c, h, w = x.shape
        p = self.patch
        assert h % p == 0 and w % p == 0, "patch must divide feature map"
        nh, nw = h // p, w // p
        xp = x.reshape(b, c, nh, p, nw, p).permute(0, 2, 4, 1, 3, 5)
        y = self.nl(xp.reshape(b * nh * nw, c, p, p))
        y = y.reshape(b, nh, nw, c, p, p).permute(0, 3, 1, 4, 2, 5)
        return y.reshape(b, c, h, w)


QUADS = ("lt", "lb", "rt", "rb")


def _quadrants(x):
    hh, hw = x.shape[2] // 2, x.shape[3] // 2
    return {"lt": x[:, :, :hh, :hw], "lb": x[:, :, hh:, :hw],
            "rt": x[:, :, :hh, hw:], "rb": x[:, :, hh:, hw:]}


def _fuse_halves(module, q):
    """Left|right and top|bottom re-assemblies of the quadrants ``q``,
    each through its conv (``conv_l`` ...), side by side in channels."""
    left = module.conv_l(torch.cat([q["lt"], q["lb"]], dim=2))
    right = module.conv_r(torch.cat([q["rt"], q["rb"]], dim=2))
    top = module.conv_t(torch.cat([q["lt"], q["rt"]], dim=3))
    bot = module.conv_b(torch.cat([q["lb"], q["rb"]], dim=3))
    lr = torch.cat([left, right], dim=3)
    tb = torch.cat([top, bot], dim=2)
    return torch.cat([lr, tb], dim=1)


def _channel_conv(cin, cout, channel_cat, k, act):
    if channel_cat == "linear":
        return Conv2d(cin, cout, 1)
    return ConvNormAct(cin, cout, k, 1, act=act)


class PatchConvNonLocal(nn.Module):
    """Quadrant non-local downsampler (Non_local_family.py:50): each
    quadrant a stride-2 3x3 conv and a dot non-local at ``mid`` channels,
    the left/right and top/bottom re-assemblies conv'd and fused 1x1.
    Output (out_channels, H/2, W/2)."""

    def __init__(self, in_channels: int, out_channels: int,
                 channel_scale: float = 0.5, channel_cat: str = "linear",
                 act: str = "silu"):
        super().__init__()
        mid = int(channel_scale * in_channels)
        for k in QUADS:
            self.add_module(f"conv_{k}", ConvNormAct(in_channels, mid, 3, 2,
                                                     act=act))
            self.add_module(f"nl_{k}", NonLocalBlock(mid,
                                                     inter_channels=mid))
        for k in "lrtb":
            self.add_module(f"conv_{k}", ConvNormAct(mid, mid, 3, 1, act=act))
        self.channel_conv = _channel_conv(2 * mid, out_channels, channel_cat,
                                          1, act)

    def forward(self, x):
        q = {k: getattr(self, f"nl_{k}")(getattr(self, f"conv_{k}")(v))
             for k, v in _quadrants(x).items()}
        return self.channel_conv(_fuse_halves(self, q))


class SpatialAttention(nn.Module):
    """CBAM spatial gate (Non_local_family.py:423): channel max and mean,
    a k x k conv to one channel, sigmoid; returns the (B, 1, H, W) map."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = Conv2d(2, 1, kernel_size, padding=kernel_size // 2)

    def forward(self, x):
        stats = torch.cat([x.amax(dim=1, keepdim=True),
                           x.mean(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv(stats))


class PatchNonLocalQuad(nn.Module):
    """Quadrant non-local at full resolution (Non_local_family.py:206):
    a dot non-local per quadrant at ``channel_scale * C`` inter channels,
    re-assembled, then ``channel_conv`` (1x1, or 3x3 ConvNormAct)."""

    def __init__(self, in_channels: int, out_channels: int,
                 channel_scale: float = 0.5,
                 channel_cat: str = "non_linear", act: str = "silu"):
        super().__init__()
        mid = max(int(channel_scale * in_channels), 1)
        for k in QUADS:
            self.add_module(f"nl_{k}", NonLocalBlock(in_channels,
                                                     inter_channels=mid))
        self.channel_conv = _channel_conv(in_channels, out_channels,
                                          channel_cat, 3, act)

    def forward(self, x):
        q = {k: getattr(self, f"nl_{k}")(v) for k, v in _quadrants(x).items()}
        top = torch.cat([q["lt"], q["rt"]], dim=3)
        bot = torch.cat([q["lb"], q["rb"]], dim=3)
        return self.channel_conv(torch.cat([top, bot], dim=2))


class VANAttention(nn.Module):
    """VAN-style wrapper (Non_local_family.py:252): 1x1 -> exact GELU ->
    :class:`PatchNonLocalQuad` at channel_scale 1 -> 1x1 -> residual."""

    def __init__(self, channels: int, act: str = "silu"):
        super().__init__()
        self.proj_1 = Conv2d(channels, channels, 1)
        self.sgu = PatchNonLocalQuad(channels, channels, channel_scale=1.0,
                                     act=act)
        self.proj_2 = Conv2d(channels, channels, 1)

    def forward(self, x):
        y = F.gelu(self.proj_1(x))              # torch's exact default
        return x + self.proj_2(self.sgu(y))


class PatchConvNonLocal44(nn.Module):
    """4x4-grid non-local downsampler (Non_local_family.py:359): a
    :class:`PatchConvNonLocal` per quadrant, the four (H/4, W/4) outputs
    re-assembled along both half axes through 1x1 convs to ``mid``, fused.
    Output (out_channels, H/2, W/2)."""

    def __init__(self, in_channels: int, out_channels: int,
                 channel_scale: float = 0.5, channel_cat: str = "linear",
                 act: str = "silu"):
        super().__init__()
        mid = max(int(channel_scale * in_channels), 1)
        for k in QUADS:
            self.add_module(f"patch_{k}", PatchConvNonLocal(
                in_channels, out_channels, channel_scale=channel_scale,
                act=act))
        for k in "lrtb":
            self.add_module(f"conv_{k}", ConvNormAct(out_channels, mid, 1, 1,
                                                     act=act))
        self.channel_conv = _channel_conv(2 * mid, out_channels, channel_cat,
                                          1, act)

    def forward(self, x):
        q = {k: getattr(self, f"patch_{k}")(v)
             for k, v in _quadrants(x).items()}
        return self.channel_conv(_fuse_halves(self, q))


def _mass_centroid(mass: torch.Tensor, size: int) -> torch.Tensor:
    """First index where the cumulative mass passes half the total,
    floored to even and clamped to [4, size - 4] (a 0-dim int64 tensor;
    no host sync)."""
    csum = torch.cumsum(mass, 0)
    idx = torch.argmax((csum > 0.5 * csum[-1]).to(torch.uint8))
    return torch.clamp(torch.div(idx, 2, rounding_mode="floor") * 2,
                       4, size - 4)


def _roll(x: torch.Tensor, shift: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.roll`` by a 0-dim tensor shift, as a gather."""
    n = x.shape[dim]
    idx = torch.remainder(torch.arange(n, device=x.device) - shift, n)
    return x.index_select(dim, idx)


class PatchConvNonLocalAdapt(nn.Module):
    """Centroid-adaptive quadrant non-local (Non_local_family.py:272, the
    JAX package's fixed-shape re-design): the CBAM map, thresholded at
    3/4 of its global range, gives the mass centroid of the rows and then
    of each half's columns; the map is rolled so each lands on the half
    boundary, processed as fixed quadrants, unrolled, and gated by the
    unthresholded map."""

    def __init__(self, in_channels: int, out_channels: int,
                 channel_scale: float = 0.5,
                 channel_cat: str = "non_linear", act: str = "silu"):
        super().__init__()
        mid = max(int(channel_scale * in_channels), 1)
        self.attention_map = SpatialAttention()
        for k in QUADS:
            self.add_module(f"nl_{k}", NonLocalBlock(in_channels,
                                                     inter_channels=mid))
        self.conv_t = ConvNormAct(in_channels, mid, 3, 1, act=act)
        self.conv_b = ConvNormAct(in_channels, mid, 3, 1, act=act)
        self.channel_conv = _channel_conv(mid, out_channels, channel_cat, 3,
                                          act)

    def forward(self, x):
        _, _, h, w = x.shape
        attn = self.attention_map(x)                         # (B, 1, H, W)
        lo, hi = attn.min(), attn.max()
        thr = lo + 0.75 * (hi - lo)
        tmap = torch.where(attn < thr, torch.zeros_like(attn), attn)[:, 0]
        cx = _mass_centroid(tmap.sum(dim=(0, 2)), h)
        x_r = _roll(x, h // 2 - cx, 2)
        t_r = _roll(tmap, h // 2 - cx, 1)
        cy_t = _mass_centroid(t_r[:, :h // 2].sum(dim=(0, 1)), w)
        cy_b = _mass_centroid(t_r[:, h // 2:].sum(dim=(0, 1)), w)
        top_x = _roll(x_r[:, :, :h // 2], w // 2 - cy_t, 3)
        bot_x = _roll(x_r[:, :, h // 2:], w // 2 - cy_b, 3)
        hw = w // 2
        q = {"lt": top_x[..., :hw], "rt": top_x[..., hw:],
             "lb": bot_x[..., :hw], "rb": bot_x[..., hw:]}
        q = {k: getattr(self, f"nl_{k}")(v) for k, v in q.items()}
        top = self.conv_t(torch.cat([q["lt"], q["rt"]], dim=3))
        bot = self.conv_b(torch.cat([q["lb"], q["rb"]], dim=3))
        top = _roll(top, cy_t - w // 2, 3)
        bot = _roll(bot, cy_b - w // 2, 3)
        y = _roll(torch.cat([top, bot], dim=2), cx - h // 2, 2)
        return attn * self.channel_conv(y)
