"""Fused GroupNorm -> ReLU -> int8 requant: wrappers of the CUDA kernel
(``csrc/gn_quant.cu``) and their plain PyTorch versions.

Replaces ``glsdet_tpu/ops/pallas_gn.py: gn_relu_quant``, the step after
every int8 head-tower convolution (``quant_static.py: _int8_head_forward``;
``ops/quant_static.py: Int8MPHead`` here).  Two entries:

- :func:`gn_relu_quant` takes the bf16 tensor, as the Pallas kernel does;
- :func:`gn_relu_quant_acc` takes the int32 accumulator of the int8
  convolution and its per-channel scale ``deq`` and dequantizes on load,
  so the towers write no float tensor between the GEMM and the GN.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it launches the kernel on that tensor's card (an affine, scale or
accumulator on another card raises ``ValueError``) or raises.  Each
launch reports its bytes to ``ops/cost.py``'s active counter as the
bound counts them: the source read once (int32 or bf16), the int8 codes
written once; its few elementwise operations per value are not counted
as products.  Two differences from the JAX package,
both deliberate: the CUDA kernel has no eligibility gate (the Pallas
kernel refused H or W not a multiple of 8, C not a multiple of 128 and
levels over VMEM, and sent those to XLA), and nothing mirrors the
``GLSDET_PALLAS_GN`` knob: on the card the int8 towers always call the
kernel.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from glsdet_tpu_torch.native import kernels
from glsdet_tpu_torch.ops import cost

CHUNK_PIXELS = 256    # pixels per block of the streaming statistics pass
MAX_C = 2048          # the kernels hold 2C scales and biases per block
MAX_BATCH = 65535     # the kernels' grid holds one image per row

launches = 0          # wrapper calls that launched the kernel since a reset
launches_by_device = collections.Counter()   # of them, per card index

# per (device, stream): MAX_BATCH uint32 counters of the streaming regime,
# which the kernel leaves at 0; made once and never freed, so a call on
# another stream never shares them and a captured graph never outlives them
_counters = {}
# (device, source dtype, B, H*W, C) -> whether the card runs it resident
_resident = {}


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


def gn_relu_quant_acc_plain(acc: torch.Tensor, deq: torch.Tensor,
                            gamma: torch.Tensor, beta: torch.Tensor,
                            s_out: float, groups: int = 32, eps: float = 1e-6,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """:func:`gn_relu_quant_plain` of the dequantized accumulator
    ``(acc.float() * deq).to(dtype)``: the tensor ``QConv`` and the JAX
    package's int8 head build before the GN."""
    y = (acc.float() * deq.float()).to(dtype)
    return gn_relu_quant_plain(y, gamma, beta, s_out, groups, eps)


def _check_affine(c: int, dev: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, the input on {dev}: "
                             "inputs must share a card")
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous ({c},) float32 "
                             f"on {dev}")


def _check_input(x: torch.Tensor, dtype: torch.dtype, groups: int) -> int:
    """Raises on what the kernel cannot take; returns the group count."""
    if x.device.type != "cuda":
        raise ValueError(f"no GN kernel for device {x.device}")
    if x.dim() != 4 or x.dtype != dtype:
        raise TypeError(f"expected (B, H, W, C) {dtype}, got "
                        f"{tuple(x.shape)} {x.dtype}")
    c = x.shape[-1]
    g = min(groups, c)
    if c % 8 or c > MAX_C or c % g:
        raise ValueError(f"C = {c}: needs a multiple of 8 up to {MAX_C} "
                         f"and of groups = {g}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("input must be contiguous and 16-byte aligned")
    if x.shape[0] > MAX_BATCH:
        raise ValueError(f"batch {x.shape[0]} > {MAX_BATCH}")
    return g


def _scratch(x: torch.Tensor, b: int, hw: int, c: int):
    """The streaming regime's workspace and counters, or (None, None) where
    the shape runs resident.  The workspace comes from the caching
    allocator, which orders it by the stream; a call made while a CUDA
    graph is captured gets counters of its own, zeroed at each replay,
    since the graph may replay on any stream."""
    key = (x.device, x.dtype, b, hw, c)
    if key not in _resident:
        _resident[key] = plan(x.dtype, b, 1, hw, c,
                              x.device)["regime"] == "resident"
    if _resident[key]:
        return None, None
    dev = x.device
    work = torch.empty(b * (-(-hw // CHUNK_PIXELS) + 1) * 2 * c,
                       dtype=torch.float32, device=dev)
    if torch.cuda.is_current_stream_capturing():
        return work, torch.zeros(b, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counter = _counters.get((dev, stream))
    if counter is None:
        counter = torch.zeros(MAX_BATCH, dtype=torch.int32, device=dev)
        _counters[(dev, stream)] = counter
    return work, counter


def _launch(fn: str, x: torch.Tensor, deq, gamma, beta, s_out, g, eps):
    global launches
    # the kernel's division assumes a normal, finite divisor
    if not (math.isfinite(s_out) and s_out >= 2.0 ** -126):
        raise ValueError(f"s_out = {s_out}: needs a positive normal float")
    b, h, w, c = x.shape
    out = torch.empty((b, h, w, c), dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return out
    lib = kernels.load_kernels()
    args = [x.data_ptr()] + ([] if deq is None else [deq.data_ptr()])
    with torch.cuda.device(x.device):
        work, counter = _scratch(x, b, h * w, c)
        kernels.check(getattr(lib, fn)(
            *args, gamma.data_ptr(), beta.data_ptr(), float(s_out),
            float(eps), b, h * w, c, g, CHUNK_PIXELS,
            None if work is None else work.data_ptr(),
            None if counter is None else counter.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), fn)
    launches += 1
    launches_by_device[x.device.index] += 1
    if cost.current() is not None:
        cost.report(cost.tensor_bytes(x) + cost.tensor_bytes(out))
    return out


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
    if y.device.type == "cpu":
        return gn_relu_quant_plain(y, gamma, beta, s_out, groups, eps)
    g = _check_input(y, torch.bfloat16, groups)
    _check_affine(y.shape[-1], y.device, gamma=gamma, beta=beta)
    return _launch("glsdet_gn_relu_quant", y, None, gamma, beta, s_out, g,
                   eps)


def gn_relu_quant_acc(acc: torch.Tensor, deq: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor, s_out: float,
                      groups: int = 32, eps: float = 1e-6,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`gn_relu_quant` of ``(acc.float() * deq).to(dtype)``, with the
    dequantization done on load by the kernel.

    Args:
        acc: (B, H, W, C) int32 accumulator of an int8 convolution
            (``Int8Conv2d``); on the card contiguous and 16-byte aligned.
        deq: (C,) float32 dequantization scale ``s_w * s_x`` (``QConv.deq``).
        gamma, beta, s_out, groups, eps: as :func:`gn_relu_quant`.
        dtype: the dequantized tensor's type; on the card bfloat16 (the
            kernel's), on the CPU also float32 (the float32 towers).

    Returns the (B, H, W, C) int8 codes.
    """
    if acc.device.type == "cpu":
        return gn_relu_quant_acc_plain(acc, deq, gamma, beta, s_out, groups,
                                       eps, dtype)
    if dtype != torch.bfloat16:
        raise TypeError(f"the GN kernel dequantizes to bfloat16, not {dtype}")
    g = _check_input(acc, torch.int32, groups)
    _check_affine(acc.shape[-1], acc.device, deq=deq, gamma=gamma, beta=beta)
    return _launch("glsdet_gn_relu_quant_acc", acc, deq, gamma, beta, s_out,
                   g, eps)


def plan(src_dtype: torch.dtype, b: int, h: int, w: int, c: int,
         device=None) -> dict:
    """The regime the kernel takes at (B, H, W, C) for a ``src_dtype``
    (bfloat16: :func:`gn_relu_quant`, int32: :func:`gn_relu_quant_acc`)
    on the current CUDA device: ``regime`` "resident" (one launch, one
    cluster of ``cluster`` blocks per image, ``stages`` ring stages,
    ``smem_bytes`` per block, ``active_clusters`` of them at once) or
    "streaming" (two launches)."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        kernels.check(kernels.load_kernels().glsdet_gn_plan(
            4 if src_dtype == torch.int32 else 2, b, h * w, c, out),
            "glsdet_gn_plan")
    resident = out[0] == 1
    return {"regime": "resident" if resident else "streaming",
            "kernel_launches": 1 if resident else 2, "cluster": out[1],
            "stages": out[2], "smem_bytes": out[3],
            "active_clusters": out[4]}
