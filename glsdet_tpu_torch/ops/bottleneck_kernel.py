"""Fused identity ResNet bottleneck: wrapper of the CUDA kernel
(``csrc/bottleneck.cu``), its plain PyTorch version, and the weight
packing that feeds the kernel.

Replaces ``glsdet_tpu/ops/pallas_bottleneck.py: fused_bottleneck``, which
``ops/fused_infer.py`` runs for every identity ``Bottleneck`` of MP-Det's
ResNet.  With BN folded into each convolution:

    y1 = relu(x @ w1 + b1)                 1x1, 4C -> C
    y2 = relu(conv3x3(y1, w2) + b2)        3x3 SAME, C -> C
    y  = relu(y2 @ w3 + b3 + x)            1x1, C -> 4C, residual

bf16 operands, f32 sums, bf16 intermediates, the result in ``x.dtype``.
Tensors are NHWC.  On a CPU tensor the wrapper computes the plain version;
on a CUDA tensor it launches the kernel on that tensor's card (operands on
another card raise ``ValueError``) or raises.  Each launch reports to
``ops/cost.py``'s active counter the three convolutions' 2 x MACs (34 C^2
a pixel) and the bytes its bound counts: x read and y written in bf16,
the packed weights and the biases read once.

The kernel runs its products on ``wgmma`` and streams the weights through a
ring in shared memory, one K-chunk at a time, multicast to the blocks of a
thread-block cluster (``csrc/bottleneck.cu`` has the design and the tile
plan).  Each chunk is one contiguous copy, in the layout the ``wgmma``
descriptor reads, so the weights are packed ahead of time:
:func:`pack_weights` (and its inverse :func:`unpack_weights`) cut each
(K, N) weight into chunks of ``KC`` rows by ``NCH`` columns (``PLAN``),
orders them as the kernel reads them (column pass outer, K chunk inner),
and lays each chunk out as 8 x 8 core matrices, ``[n / 8][k / 8][n % 8][k %
8]``.  ``FusedBottleneck`` packs once when it folds; the wrapper packs on
the fly when it is given no packed weights.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from glsdet_tpu_torch.native import kernels
from glsdet_tpu_torch.ops import cost

# bottleneck widths C the kernel takes (4C = 64 ... 2048)
KERNEL_C = (16, 32, 64, 128, 256, 512)

launches = 0          # kernel launches since the last reset
launches_by_device = collections.Counter()   # of them, per card index

# The kernel's tile plan (``csrc/bottleneck.cu: Plan<C>``), per C: output
# tile rows TH, cluster size CL, and for conv1, conv2, conv3 the K rows per
# chunk KC and the columns per pass NCH (the split is the kernel's own
# business).  tests/test_torch_bottleneck_pack.py holds it to the source.
PLAN = {16: (8, 1, (32, 16), (16, 16), (16, 64)),
        32: (8, 1, (32, 32), (32, 32), (32, 128)),
        64: (8, 1, (32, 64), (64, 64), (32, 128)),
        128: (8, 2, (64, 128), (64, 128), (64, 256)),
        256: (8, 4, (32, 128), (64, 256), (64, 256)),
        512: (4, 4, (32, 256), (32, 512), (32, 512))}


def _shapes(c: int):
    """(K, N) of w1, w2, w3 for bottleneck width C."""
    return (4 * c, c), (9 * c, c), (c, 4 * c)


def pack_weights(w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor):
    """w1 (4C, C), w2 (9C, C), w3 (C, 4C) -> three flat bf16 buffers in the
    kernel's chunk order and core-matrix layout (module docstring), on the
    weights' device."""
    c = w1.shape[1]
    if c not in PLAN:
        raise ValueError(f"C = {c}: the kernel takes C in {KERNEL_C}")
    out = []
    for w, (k, n), (kc, nch) in zip((w1, w2, w3), _shapes(c), PLAN[c][2:]):
        if tuple(w.shape) != (k, n):
            raise ValueError(f"expected a ({k}, {n}) weight, got "
                             f"{tuple(w.shape)}")
        blocks = w.to(torch.bfloat16).reshape(k // kc, kc // 8, 8, n // nch,
                                              nch // 8, 8)
        # [kc, kg, k8, pass, ng, n8] -> [pass, kc, ng, kg, n8, k8]
        out.append(blocks.permute(3, 0, 4, 1, 5, 2).contiguous().reshape(-1))
    return tuple(out)


def unpack_weights(p1: torch.Tensor, p2: torch.Tensor, p3: torch.Tensor,
                   c: int):
    """The inverse of :func:`pack_weights`: (w1, w2, w3) in bf16."""
    out = []
    for p, (k, n), (kc, nch) in zip((p1, p2, p3), _shapes(c), PLAN[c][2:]):
        blocks = p.reshape(n // nch, k // kc, nch // 8, kc // 8, 8, 8)
        out.append(blocks.permute(1, 3, 5, 0, 2, 4).reshape(k, n))
    return tuple(out)


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


def _check_packed(packed, c: int, device) -> tuple:
    sizes = [k * n for k, n in _shapes(c)]
    if (len(packed) != 3 or any(
            t.dtype != torch.bfloat16 or t.dim() != 1 or t.numel() != size
            or t.device != device or not t.is_contiguous()
            for t, size in zip(packed, sizes))):
        raise ValueError(f"packed: expected three contiguous bf16 buffers of "
                         f"{sizes} elements on {device} (pack_weights)")
    return tuple(packed)


def fused_bottleneck(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                     b3: torch.Tensor, packed=None) -> torch.Tensor:
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
        packed: ``pack_weights(w1, w2, w3)`` made ahead of time, which the
            kernel reads in place of w1, w2, w3 (``FusedBottleneck`` keeps
            them); None packs on the fly.  The plain version ignores it.

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
    wp = (pack_weights(w1, w2, w3) if packed is None
          else _check_packed(packed, c, x.device))
    ops = [xb, wp[0], b1.float().contiguous(), wp[1],
           b2.float().contiguous(), wp[2], b3.float().contiguous()]
    out = torch.empty_like(xb)
    if out.numel() == 0:
        return out.to(x.dtype)
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("operands must be 16-byte aligned")
    lib = kernels.load_kernels()
    with torch.cuda.device(x.device):
        kernels.check(lib.glsdet_fused_bottleneck(
            *(t.data_ptr() for t in ops), out.data_ptr(), bsz, h, w, c,
            torch.cuda.current_stream().cuda_stream),
            "glsdet_fused_bottleneck")
    launches += 1
    launches_by_device[x.device.index] += 1
    if cost.current() is not None:
        cost.report(sum(map(cost.tensor_bytes, ops))
                    + cost.tensor_bytes(out),
                    flops=34 * c * c * bsz * h * w)
    return out.to(x.dtype)

