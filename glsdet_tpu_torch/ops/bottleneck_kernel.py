"""Fused identity ResNet bottleneck: wrapper of the CUDA kernel
(``csrc/bottleneck.cu``) and its plain PyTorch version.

Replaces ``glsdet_tpu/ops/pallas_bottleneck.py: fused_bottleneck``, which
``ops/fused_infer.py`` runs for every identity ``Bottleneck`` of MP-Det's
ResNet.  With BN folded into each convolution:

    y1 = relu(x @ w1 + b1)                 1x1, 4C -> C
    y2 = relu(conv3x3(y1, w2) + b2)        3x3 SAME, C -> C
    y  = relu(y2 @ w3 + b3 + x)            1x1, C -> 4C, residual

bf16 operands, f32 sums, bf16 intermediates, the result in ``x.dtype``.
Tensors are NHWC.  On a CPU tensor the wrapper computes the plain version;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from glsdet_tpu_torch.native import kernels

# bottleneck widths C the kernel takes (4C = 64 ... 2048)
KERNEL_C = (16, 32, 64, 128, 256, 512)

launches = 0          # kernel launches since the last reset


def fused_bottleneck_plain(x: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor, w3: torch.Tensor,
                           b3: torch.Tensor) -> torch.Tensor:
    """The kernel's semantics in PyTorch, on any device and input dtype:
    x and the weights round to bf16; each product sums in float32 (bf16
    values as float32 operands); each ReLU'd intermediate rounds to bf16;
    the 3x3 pads y1 with zeros (conv1 outputs outside the image are 0,
    not ``relu(b1)``); the residual is the bf16-rounded x; the result is
    cast to ``x.dtype``.  The 3x3 is nine shifted products summed in tap
    order.  On the card, float32 products must not run in TF32
    (``torch.backends.cuda.matmul.allow_tf32``, False by default)."""
    _, h, w, _ = x.shape
    c = w1.shape[1]

    def bf(t):
        return t.to(torch.bfloat16).float()

    xb = bf(x)
    y1 = bf(torch.relu(xb @ bf(w1) + b1.float()))
    y1 = F.pad(y1, (0, 0, 1, 1, 1, 1))
    w2b = bf(w2).reshape(9, c, c)
    acc = None
    for tap in range(9):
        dh, dw = divmod(tap, 3)
        part = y1[:, dh:dh + h, dw:dw + w] @ w2b[tap]
        acc = part if acc is None else acc + part
    y2 = bf(torch.relu(acc + b2.float()))
    return torch.relu(y2 @ bf(w3) + b3.float() + xb).to(x.dtype)


def _check_operands(x, w1, b1, w2, b2, w3, b3) -> int:
    """Shapes, devices and layout the kernel takes; returns C."""
    if x.dim() != 4:
        raise ValueError(f"x: expected (B, H, W, 4C), got {tuple(x.shape)}")
    cin = x.shape[-1]
    c = cin // 4
    if cin != 4 * c or c not in KERNEL_C:
        raise ValueError(f"4C = {cin}: the kernel takes C in {KERNEL_C}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"x: expected a float dtype, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous")
    want = {"w1": (w1, (cin, c)), "b1": (b1, (c,)), "w2": (w2, (9 * c, c)),
            "b2": (b2, (c,)), "w3": (w3, (c, cin)), "b3": (b3, (cin,))}
    for name, (t, shape) in want.items():
        if (tuple(t.shape) != shape or t.device != x.device
                or not t.is_floating_point()):
            raise ValueError(f"{name}: expected a float {shape} tensor on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    return c


def fused_bottleneck(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                     b3: torch.Tensor) -> torch.Tensor:
    """Fused identity-bottleneck forward.

    Args:
        x: (B, H, W, 4C) NHWC-contiguous, any float dtype (computed in
            bf16).  On the card C must be one of ``KERNEL_C``.
        w1: (4C, C) folded conv1;  b1: (C,) folded bias.
        w2: (9C, C) folded conv2 in the JAX tap order (row (dh * 3 + dw)
            * C + ci), the HWIO kernel reshaped;  b2: (C,).
        w3: (C, 4C) folded conv3;  b3: (4C,).
        Weights are used as bf16 and biases as float32; the casts are
        no-ops for operands already in those types.

    Returns (B, H, W, 4C) NHWC-contiguous in ``x.dtype``.
    """
    global launches
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"no bottleneck kernel for device {x.device}")
    c = _check_operands(x, w1, b1, w2, b2, w3, b3)
    bsz, h, w, cin = x.shape
    xb = x.to(torch.bfloat16)
    ops = [xb] + [t.to(dt).contiguous() for t, dt in (
        (w1, torch.bfloat16), (b1, torch.float32),
        (w2, torch.bfloat16), (b2, torch.float32),
        (w3, torch.bfloat16), (b3, torch.float32))]
    out = torch.empty_like(xb)
    if out.numel() == 0:
        return out.to(x.dtype)
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("operands must be 16-byte aligned")
    lib = kernels.load_kernels()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kernels.check(lib.glsdet_fused_bottleneck(
        *(t.data_ptr() for t in ops), out.data_ptr(), bsz, h, w, c, stream),
        "glsdet_fused_bottleneck")
    launches += 1
    return out.to(x.dtype)
