"""Fused GroupNorm -> ReLU -> int8 requant: wrapper of the CUDA kernel
(``csrc/gn_quant.cu``) and its plain PyTorch version.

Replaces ``glsdet_tpu/ops/pallas_gn.py: gn_relu_quant``, the step after
every int8 head-tower convolution (``quant_static.py: _int8_head_forward``;
``ops/quant_static.py: Int8MPHead`` here).  On a CPU tensor the wrapper
computes the plain version; on a CUDA tensor it launches the kernel or
raises.  Two differences from the JAX package, both deliberate: the CUDA
kernel has no eligibility gate (the Pallas kernel refused H or W not a
multiple of 8, C not a multiple of 128 and levels over VMEM, and sent
those to XLA), and nothing mirrors the ``GLSDET_PALLAS_GN`` knob: on the
card the int8 towers always call the kernel.
"""

from __future__ import annotations

import torch

from glsdet_tpu_torch.native import kernels

CHUNK_PIXELS = 256    # pixels per block of the statistics pass
MAX_C = 2048          # the statistics pass holds 8 * C floats per block

launches = 0          # kernel launches since the last reset


def gn_relu_quant_plain(y: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, s_out: float, groups: int = 32,
                        eps: float = 1e-6) -> torch.Tensor:
    """(B, H, W, C) -> int8 codes.  Group statistics in float32
    (``var = E[y^2] - mean^2``), ``v = relu(y * rstd*gamma + (beta -
    mean * rstd*gamma))``, then ``clip(round(v / s_out), -127, 127)``.

    With a bfloat16 ``y``, ``v`` is rounded to bfloat16 before the requant:
    the kernel's semantics (and the Pallas kernel's).  With a float32
    ``y`` it stays float32: ``quant_static._gn_relu`` at float32 followed
    by the requant, which the CPU tests compare against.  Divisions are
    by tensors, so on the card they are true divisions as in the kernel
    (PyTorch turns a division by a Python scalar into a multiplication by
    its reciprocal there)."""
    b, h, w, c = y.shape
    g = min(groups, c)
    dev = y.device

    def div(x, d):
        return x / torch.tensor(d, dtype=torch.float32, device=dev)

    yf = y.float().reshape(b, h * w, g, c // g)
    n = float(h * w * (c // g))
    mean = div(yf.sum(dim=(1, 3), keepdim=True), n)
    var = div((yf * yf).sum(dim=(1, 3), keepdim=True), n) - mean * mean
    rstd = torch.sqrt(var + eps).reciprocal()
    scale = rstd * gamma.float().reshape(g, c // g)
    bias = beta.float().reshape(g, c // g) - mean * scale
    v = torch.relu(yf * scale + bias)
    if y.dtype == torch.bfloat16:
        v = v.to(torch.bfloat16).float()
    q = torch.clamp(torch.round(div(v, s_out)), -127, 127)
    return q.to(torch.int8).reshape(b, h, w, c)


def gn_relu_quant(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  s_out: float, groups: int = 32, eps: float = 1e-6
                  ) -> torch.Tensor:
    """GroupNorm(groups, eps) -> ReLU -> bf16 -> int8 codes of scale
    ``s_out``.

    Args:
        y: (B, H, W, C) NHWC; on the card bfloat16, contiguous, 16-byte
            aligned, C a multiple of 8 up to 2048.
        gamma, beta: (C,) float32 GroupNorm affine, on ``y``'s device.
        s_out: the output's int8 scale.

    Returns the (B, H, W, C) int8 codes.
    """
    global launches
    if y.device.type == "cpu":
        return gn_relu_quant_plain(y, gamma, beta, s_out, groups, eps)
    if y.device.type != "cuda":
        raise ValueError(f"no GN kernel for device {y.device}")
    if y.dim() != 4 or y.dtype != torch.bfloat16:
        raise TypeError(f"y: expected (B, H, W, C) bfloat16, got "
                        f"{tuple(y.shape)} {y.dtype}")
    b, h, w, c = y.shape
    g = min(groups, c)
    if c % 8 or c > MAX_C or c % g:
        raise ValueError(f"C = {c}: needs a multiple of 8 up to {MAX_C} "
                         f"and of groups = {g}")
    if not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError("y must be contiguous and 16-byte aligned")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or t.device != y.device or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous ({c},) float32 "
                             f"on {y.device}")
    out = torch.empty((b, h, w, c), dtype=torch.int8, device=y.device)
    if y.numel() == 0:
        return out
    nchunk = -(-(h * w) // CHUNK_PIXELS)
    partial = torch.empty((b, nchunk, 2, c), dtype=torch.float32,
                          device=y.device)
    scale_bias = torch.empty((b, 2, c), dtype=torch.float32, device=y.device)
    lib = kernels.load_kernels()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    kernels.check(lib.glsdet_gn_relu_quant(
        y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), float(s_out),
        float(eps), b, h * w, c, g, CHUNK_PIXELS, partial.data_ptr(),
        scale_bias.data_ptr(), out.data_ptr(), stream),
        "glsdet_gn_relu_quant")
    launches += 1
    return out
