"""int8 x int8 -> int32 convolution in NHWC, and the int8 helpers the
quantized serving modes share.

The counterpart of the XLA calls ``conv_general_dilated(int8, int8,
preferred_element_type=int32)`` of ``glsdet_tpu/ops/quant_static.py``
(``_quant_bare_conv``, ``_quant_module_call``, ``_qconv``,
``_int8_head_forward``) and ``glsdet_tpu/ops/quant.py``
(``quantize_conv_output``).  It is an XLA convolution there, not a Pallas
kernel, and here it is a product of library matrices:

- an NHWC im2col with the column order (kh, kw, cin), which is the row
  order of the HWIO weight, so ``OIHW.permute(2, 3, 1, 0)`` reshapes to
  match (a 1x1 convolution at stride 1 needs no im2col, at stride 2 it
  is a strided slice);
- on the card, ``torch._int_mm`` (cuBLASLt int8 GEMM, exact int32
  accumulation).  Its contract, checked by ``chip_smoke.py`` and
  ``tests/test_torch_cuda.py``: more than 16 rows, inner and output sizes
  multiples of 8.  :class:`Int8Conv2d` pads the weight once and the rows
  per call to meet it;
- on the CPU, a float64 matmul, exact because every partial sum is an
  integer below 9 * 2048 * 127**2 < 2**53.

A depthwise convolution (groups = C, reached by the dynamic mode on
depthwise models) is an exact int32 multiply and sum over the taps on
both devices.  No float convolution ever sees int8 codes: cuDNN's
Winograd and FFT algorithms are not exact.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from glsdet_tpu_torch.ops import cost

MM_MIN_ROWS = 17      # torch._int_mm on CUDA takes more than 16 rows
MM_ALIGN = 8          # ... and inner/output sizes that are multiples of 8


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 weight of a float32 OIHW kernel:
    ``s_w = max(max|w[o]|, 1e-8) / 127``, ``q = round(w / s_w)``, as
    ``quant_static.py:329-331`` and ``quant.py:80-82``."""
    w = w.float()
    s_w = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-8) / 127.0
    return torch.round(w / s_w[:, None, None, None]).to(torch.int8), s_w


def requant(x: torch.Tensor, scale) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8 codes (x float32;
    ``round`` is half to even, as ``jnp.round``)."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def fake_quant(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Round to the symmetric int8 grid and keep the dtype
    (``quant_static.py: _fq``)."""
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return (q * scale).to(x.dtype)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def im2col(q_x: torch.Tensor, kh: int, kw: int, stride: Tuple[int, int],
           padding: Tuple[int, int], dilation: Tuple[int, int] = (1, 1)
           ) -> Tuple[torch.Tensor, int, int]:
    """(B, H, W, C) int8 -> (B * Ho * Wo, kh * kw * C) patches, columns in
    (kh, kw, cin) order, taps ``dilation`` apart; zero padding (the zero
    code)."""
    b, h, w, c = q_x.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if kh == kw == 1 and ph == pw == 0:
        x = q_x if sh == sw == 1 else q_x[:, ::sh, ::sw, :]
        return x.reshape(b * ho * wo, c), ho, wo
    x = F.pad(q_x, (0, 0, pw, pw, ph, ph)).contiguous()
    s = x.stride()
    patches = x.as_strided((b, ho, wo, kh, kw, c),
                           (s[0], sh * s[1], sw * s[2], dh * s[1], dw * s[2],
                            s[3]))
    return patches.reshape(b * ho * wo, kh * kw * c), ho, wo


def _mm_int32(a: torch.Tensor, w_t: torch.Tensor,
              plain: bool = False) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.  K and N are
    already multiples of 8 on the card (``Int8Conv2d`` pads them).
    ``plain`` (always on the CPU): the float64 product."""
    if plain or a.device.type == "cpu":
        return (a.double() @ w_t.double()).to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"no int8 matmul for device {a.device}")
    m = a.shape[0]
    if a.shape[1] % MM_ALIGN or w_t.shape[1] % MM_ALIGN:
        raise ValueError(f"int8 GEMM needs K and N multiples of {MM_ALIGN}, "
                         f"got {tuple(a.shape)} @ {tuple(w_t.shape)}")
    if m < MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, MM_MIN_ROWS - m))
    return torch._int_mm(a.contiguous(), w_t)[:m]


def _depthwise_int32(q_x: torch.Tensor, q_w: torch.Tensor,
                     stride: Tuple[int, int], padding: Tuple[int, int],
                     dilation: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Depthwise (C, 1, kh, kw) int8 kernel over (B, H, W, C) int8 codes:
    an exact int32 sum over the taps, ``dilation`` apart."""
    b, h, w, c = q_x.shape
    _, _, kh, kw = q_w.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    x = F.pad(q_x, (0, 0, pw, pw, ph, ph)).to(torch.int32)
    wt = q_w.to(torch.int32)
    acc = torch.zeros((b, ho, wo, c), dtype=torch.int32, device=q_x.device)
    for i in range(kh):
        for j in range(kw):
            y0, x0 = i * dh, j * dw
            tap = x[:, y0:y0 + sh * (ho - 1) + 1:sh,
                    x0:x0 + sw * (wo - 1) + 1:sw]
            acc += tap * wt[:, 0, i, j]
    return acc


class Int8Conv2d(nn.Module):
    """An int8 OIHW kernel laid out once for :meth:`forward`, which maps
    (B, H, W, Cin) int8 codes to the (B, Ho, Wo, Cout) int32 accumulator.

    groups 1: the weight is kept as an (N8, K8) matrix, the (kh, kw, cin)
    columns of ``q_w.permute(0, 2, 3, 1)`` zero-padded to multiples of 8,
    and passed to the GEMM transposed (column-major, the layout cuBLASLt's
    int8 kernels take).  groups = Cin = Cout: depthwise taps.  Taps are
    ``dilation`` apart on both routes."""

    def __init__(self, q_w: torch.Tensor, stride=1, padding=0,
                 groups: int = 1, dilation=1):
        super().__init__()
        if q_w.dtype != torch.int8 or q_w.dim() != 4:
            raise TypeError("expected an int8 OIHW kernel")
        cout, cin_g, kh, kw = q_w.shape
        self.out_channels, self.kernel = cout, (kh, kw)
        self.macs_per_pixel = cout * cin_g * kh * kw
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        if groups == 1:
            k = kh * kw * cin_g
            mat = q_w.permute(0, 2, 3, 1).reshape(cout, k)
            mat = F.pad(mat, (0, -k % MM_ALIGN, 0, -cout % MM_ALIGN))
            self.register_buffer("weight", mat.contiguous())
        elif cin_g == 1 and groups == cout:
            self.register_buffer("weight", q_w.contiguous())
        else:
            raise ValueError(f"groups={groups}: only 1 or depthwise")

    def forward(self, q_x: torch.Tensor, plain: bool = False
                ) -> torch.Tensor:
        """``plain``: the float64 product on any device (the CPU route),
        which ``chip_smoke.py`` holds the card's GEMM against.  Under
        ``ops/cost.py: count_cost`` the convolution counts as 2 x its
        MACs of int8 work, whichever route and padding runs it."""
        if q_x.dtype != torch.int8 or q_x.dim() != 4:
            raise TypeError("expected (B, H, W, C) int8 codes")
        counter = cost.current()
        if counter is None:
            return self._forward(q_x, plain)
        b, h, w, _ = q_x.shape
        (kh, kw), (sh, sw) = self.kernel, self.stride
        (ph, pw), (dh, dw) = self.padding, self.dilation
        ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        with counter.product(2 * b * ho * wo * self.macs_per_pixel,
                             int8=True):
            return self._forward(q_x, plain)

    def _forward(self, q_x: torch.Tensor, plain: bool) -> torch.Tensor:
        if self.groups != 1:
            return _depthwise_int32(q_x, self.weight, self.stride,
                                    self.padding, self.dilation)
        b = q_x.shape[0]
        kh, kw = self.kernel
        cols, ho, wo = im2col(q_x, kh, kw, self.stride, self.padding,
                              self.dilation)
        k8 = self.weight.shape[1]
        if cols.shape[1] != k8:
            cols = F.pad(cols, (0, k8 - cols.shape[1]))
        acc = _mm_int32(cols, self.weight.t(), plain)
        return acc[:, :self.out_channels].reshape(b, ho, wo,
                                                  self.out_channels)


def conv2d_int8(q_x: torch.Tensor, q_w: torch.Tensor, stride=1, padding=0,
                groups: int = 1, dilation=1) -> torch.Tensor:
    """(B, H, W, Cin) int8 codes * (Cout, Cin/groups, kh, kw) int8 kernel
    -> (B, Ho, Wo, Cout) int32, exact.  groups is 1 or Cin (depthwise)."""
    return Int8Conv2d(q_w, stride, padding, groups, dilation)(q_x)


class Int8Module(nn.Module):
    """Base of the quantized modules.  Their own float tensors (scales,
    folded biases, GroupNorm affines) stay float32 when the model is
    placed in a lower compute dtype; see :func:`place_quantized`."""


def place_quantized(model: nn.Module, device, dtype: torch.dtype
                    ) -> nn.Module:
    """Move a model holding :class:`Int8Module` s to ``device``: the float
    tensors of every other module are cast to ``dtype`` (as
    ``model.to(device, dtype)`` would), those of the int8 modules keep
    float32, integer tensors keep their type."""
    for m in model.modules():
        keep = isinstance(m, Int8Module)
        m._apply(lambda t: t.to(device, dtype)
                 if t.is_floating_point() and not keep else t.to(device),
                 recurse=False)
    return model.eval()

