"""Shared building blocks (NCHW), the counterparts of ``glsdet_tpu.models.layers``.

Submodule names follow the flax scopes of the JAX package (``conv``,
``bn``, ``gn``, ``dw``, ``pw``, ``block0``, ...), so a flax variable path
and a ``state_dict`` key differ only in separators and leaf names
(``utils/flax_import.py``).

Initialisation follows the JAX package's initializers rather than
PyTorch's defaults: :func:`flax_init_` walks a model and calls each
module's ``flax_init(generator)``.  With untrained weights this matters
for behaviour, not only tidiness: the YOLOX prior-prob biases decide
whether noise frames clear a coarse score threshold of 1e-4.

Training follows flax too: :class:`BatchNorm2d` keeps its running
variance from the biased batch variance, and :func:`remat` (the JAX
package's ``nn.remat``) checkpoints a block without updating those
statistics a second time when the backward recomputes it.  In a process
group (``parallel/mesh.py``) the batch statistics are the global
batch's, as under the JAX package's global-view data parallelism.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from glsdet_tpu_torch.parallel import mesh

# torch BN(momentum=0.03, eps=1e-3) of the YOLOX configs; the JAX package
# uses the same eps for the ResNet backbone.
BN_EPS = 1e-3
BN_MOMENTUM = 0.03
GN_EPS = 1e-5

# flax's truncated normal is a standard normal cut at +-2, rescaled by
# this constant so that the variance is the requested one
_TRUNC_STD = 0.87962566103423978


_RECOMPUTING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "glsdet_torch_recomputing", default=False)


@contextlib.contextmanager
def _recomputing():
    tok = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(tok)


def _remat_contexts():
    return contextlib.nullcontext(), _recomputing()


def remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward
    instead of saved (``torch.utils.checkpoint``, non-reentrant).  While
    the backward recomputes, :class:`BatchNorm2d` leaves its running
    statistics alone, so they advance once per step as with flax's
    functional state.  Nothing in the models draws random numbers, so
    the RNG state is not saved."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=_remat_contexts)


class _GroupBatchNorm(torch.autograd.Function):
    """Training-mode batch normalisation over the whole process group's
    batch, the statistics flax takes under global view.  Each rank takes
    its mean and biased variance in one pass (``torch.var_mean``, float32
    or wider), and the group's combine those (Chan et al.'s pairwise
    update) from one gather: flax's single pass ``E[x^2] - E[x]^2``
    loses digits where a channel's mean is large against its spread,
    which at MP-Det's full width moved the dictionary rows by 2.6e-5 of
    their max against one process's cuDNN statistics.  The input is then
    normalised by ``F.batch_norm`` in eval form with the group's
    statistics.  The backward takes this rank's sums of dy and dy * x_hat
    with the eval-form ``native_batch_norm_backward`` (one fused kernel,
    which also gives dy * weight * invstd), sums them over the group (as
    ``nn.SyncBatchNorm`` does) and adds their per-channel affine term in
    x, so each rank's input gradient carries the other ranks' losses
    through the shared statistics; the weight and bias gradients are
    this rank's, summed later with the others.
    Returns ``(y, mean, biased var)``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dt = torch.promote_types(x.dtype, torch.float32)
        c = x.shape[1]
        var, mean = torch.var_mean(x.to(dt), [0, *range(2, x.dim())],
                                   correction=0)
        count = x.numel() // c
        ranks = mesh.all_gather(torch.cat([
            mean, var * count, torch.full((1,), count, dtype=dt,
                                          device=x.device)]))
        counts = ranks[:, 2 * c:]                               # (W, 1)
        n = counts.sum()
        means = ranks[:, :c]
        mean = (means * counts).sum(0) / n
        var = (ranks[:, c:2 * c].sum(0)
               + (counts * (means - mean) ** 2).sum(0)) / n
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(x, weight, mean, var, n)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, var, n = ctx.saved_tensors
        c = x.shape[1]
        shape = (1, c) + (1,) * (x.dim() - 2)
        invstd = torch.rsqrt(var + ctx.eps)
        # eval form (the statistics given, not the batch's): dx0 = dy *
        # weight * invstd, dw = sum dy * x_hat, db = sum dy, this rank's
        dx0, dw, db = torch.ops.aten.native_batch_norm_backward(
            dy.contiguous(), x, weight, mean, var, mean, invstd, False,
            ctx.eps, [True, True, True])
        group = mesh.all_sum(torch.cat([db, dw]).to(mean.dtype)) / n
        # dx = dx0 - weight * invstd * (mean(dy) + x_hat * mean(dy x_hat))
        #    = dx0 + scale * x + shift, per channel
        wi = weight.to(mean.dtype) * invstd
        scale = -wi * invstd * group[c:]
        shift = wi * (mean * invstd * group[c:] - group[:c])
        dx = torch.addcmul(shift.view(shape), x, scale.view(shape)).add_(dx0)
        return dx.to(x.dtype), dw, db, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's training semantics.

    Both normalise a training batch with its biased variance, but torch
    moves ``running_var`` towards the unbiased one (n / (n - 1) larger:
    14% at n = 8).  Here the running statistics follow flax: ``r <- (1 -
    momentum) r + momentum * batch`` with the biased variance (torch's
    ``momentum`` 0.03 is flax's 0.97).  The batch statistics come from
    ``F.batch_norm`` itself, written into fresh buffers with momentum 1;
    the unbiased variance it leaves there is scaled back by (n - 1) / n.
    Eval mode is ``nn.BatchNorm2d``'s.

    In a process group (``parallel/mesh.py: active``) the training
    statistics are the group's (:class:`_GroupBatchNorm`) and the running
    statistics move towards them, n being the group's element count.
    ``nn.SyncBatchNorm`` is not used: its running variance is the
    unbiased one."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if mesh.active():
            y, mean, var = _GroupBatchNorm.apply(x, self.weight, self.bias,
                                                 self.eps)
            if not _RECOMPUTING.get():
                with torch.no_grad():
                    self.running_mean.lerp_(
                        mean.to(self.running_mean.dtype), self.momentum)
                    self.running_var.lerp_(
                        var.to(self.running_var.dtype), self.momentum)
                    self.num_batches_tracked.add_(1)
            return y
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        if not _RECOMPUTING.get():
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var * ((n - 1) / n), self.momentum)
                self.num_batches_tracked.add_(1)
        return y


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``module`` in place with the JAX package's initializers."""
    with torch.no_grad():
        for m in module.modules():
            init = getattr(m, "flax_init", None)
            if init is not None:
                init(generator)
    return module


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that remembers which flax initializer the JAX
    package gives it.

    ``kernel_init``: ``"lecun"`` (flax's ``nn.Conv`` default,
    variance_scaling(1, fan_in, truncated normal)), ``"he_fan_out"``
    (variance_scaling(2, fan_out, truncated normal), the ConvNormAct
    and ResNet convs) or a float ``s`` for ``normal(s)``.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: int = 0,
                 groups: int = 1, bias: bool = True,
                 kernel_init="lecun", bias_value: float = 0.0,
                 dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, groups=groups,
                         bias=bias, dilation=dilation)
        self.kernel_init = kernel_init
        self.bias_value = bias_value

    def flax_init(self, generator: torch.Generator) -> None:
        rf = self.kernel_size[0] * self.kernel_size[1]
        if self.kernel_init == "lecun":
            std = math.sqrt(1.0 / (rf * self.in_channels // self.groups))
        elif self.kernel_init == "he_fan_out":
            std = math.sqrt(2.0 / (rf * self.out_channels))
        else:
            nn.init.normal_(self.weight, 0.0, float(self.kernel_init),
                            generator=generator)
            std = None
        if std is not None:
            std /= _TRUNC_STD
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        if self.bias is not None:
            self.bias.fill_(self.bias_value)


class Dense(nn.Linear):
    """``nn.Linear`` initialised as flax's ``nn.Dense``: lecun normal
    (variance_scaling(1, fan_in, truncated normal)) and zero bias."""

    def flax_init(self, generator: torch.Generator) -> None:
        std = math.sqrt(1.0 / self.in_features) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        if self.bias is not None:
            self.bias.zero_()


ACTIVATIONS = {
    "silu": F.silu,
    "relu": F.relu,
    "lrelu": lambda x: F.leaky_relu(x, 0.1),
    None: lambda x: x,
}


class ConvNormAct(nn.Module):
    """conv -> norm -> act (mmcv ``ConvModule``); norm "bn", "gn" or None."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1, groups: int = 1,
                 norm: Optional[str] = "bn", act: Optional[str] = "silu",
                 gn_groups: int = 32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           kernel_size // 2, groups=groups,
                           bias=norm is None, kernel_init="he_fan_out")
        if norm == "bn":
            self.bn = BatchNorm2d(out_channels, eps=BN_EPS,
                                  momentum=BN_MOMENTUM)
        elif norm == "gn":
            self.gn = nn.GroupNorm(min(gn_groups, out_channels),
                                   out_channels, eps=GN_EPS)
        elif norm is not None:
            raise ValueError(f"norm {norm!r}")
        self.norm = norm
        self.act = ACTIVATIONS[act]

    def forward(self, x):
        x = self.conv(x)
        if self.norm == "bn":
            x = self.bn(x)
        elif self.norm == "gn":
            x = self.gn(x)
        return self.act(x)


class DWConvBlock(nn.Module):
    """Depthwise kxk + pointwise 1x1, each with norm and act."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, act: str = "silu"):
        super().__init__()
        self.dw = ConvNormAct(in_channels, in_channels, kernel_size, stride,
                              groups=in_channels, act=act)
        self.pw = ConvNormAct(in_channels, out_channels, 1, 1, act=act)

    def forward(self, x):
        return self.pw(self.dw(x))


class Focus(nn.Module):
    """Space-to-depth stem (2x2 patches -> 4x channels) + conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, act: str = "silu"):
        super().__init__()
        self.conv = ConvNormAct(4 * in_channels, out_channels, kernel_size,
                                1, act=act)

    def forward(self, x):
        # concat order top-left, bottom-left, top-right, bottom-right,
        # as in the JAX package, so weights line up channel for channel
        tl = x[..., ::2, ::2]
        bl = x[..., 1::2, ::2]
        tr = x[..., ::2, 1::2]
        br = x[..., 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], dim=1))


class Bottleneck(nn.Module):
    """CSP bottleneck: 1x1 reduce -> 3x3 -> optional residual."""

    def __init__(self, in_channels: int, out_channels: int,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvNormAct(in_channels, hidden, 1, 1, act=act)
        if depthwise:
            self.conv2_dw = DWConvBlock(hidden, out_channels, 3, 1, act=act)
        else:
            self.conv2 = ConvNormAct(hidden, out_channels, 3, 1, act=act)
        self.residual = shortcut and in_channels == out_channels

    def forward(self, x):
        y = self.conv1(x)
        y = self.conv2_dw(y) if hasattr(self, "conv2_dw") else self.conv2(y)
        return y + x if self.residual else y


class CSPLayer(nn.Module):
    """Cross-stage-partial layer: split -> n bottlenecks -> merge."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_blocks: int = 1, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False,
                 act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.main_conv = ConvNormAct(in_channels, hidden, 1, 1, act=act)
        self.short_conv = ConvNormAct(in_channels, hidden, 1, 1, act=act)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", Bottleneck(
                hidden, hidden, shortcut=shortcut, expansion=1.0,
                depthwise=depthwise, act=act))
        self.final_conv = ConvNormAct(2 * hidden, out_channels, 1, 1,
                                      act=act)

    def forward(self, x):
        main = self.main_conv(x)
        short = self.short_conv(x)
        for i in range(self.num_blocks):
            main = getattr(self, f"block{i}")(main)
        return self.final_conv(torch.cat([main, short], dim=1))


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling: concat of 5/9/13 stride-1 max pools."""

    def __init__(self, in_channels: int, out_channels: int,
                 pool_sizes: Sequence[int] = (5, 9, 13), act: str = "silu"):
        super().__init__()
        hidden = in_channels // 2
        self.conv1 = ConvNormAct(in_channels, hidden, 1, 1, act=act)
        self.pool_sizes = tuple(pool_sizes)
        self.conv2 = ConvNormAct(hidden * (len(pool_sizes) + 1),
                                 out_channels, 1, 1, act=act)

    def forward(self, x):
        x = self.conv1(x)
        # max_pool2d pads with -inf, as flax's max_pool does
        pools = [x] + [F.max_pool2d(x, k, 1, k // 2)
                       for k in self.pool_sizes]
        return self.conv2(torch.cat(pools, dim=1))


class Scale(nn.Module):
    """Learnable scalar multiplier (mmcv ``Scale``), one per FPN level."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


def to_nhwc(x):
    """NCHW -> NHWC view: the layout of the JAX package's public outputs."""
    return x.permute(0, 2, 3, 1)


def upsample2x(x):
    """Nearest-neighbour 2x upsample (NCHW)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
