"""The host side of the fused-bottleneck kernel's weight rings
(``glsdet_tpu_torch/ops/bottleneck_kernel.py: pack_weights``), on the CPU.

The kernel (``csrc/bottleneck.cu``) reads each weight as a sequence of
contiguous chunks, chunk j at element offset j * KC * NCH of its packed
buffer, column pass outer and K chunk inner, each chunk in the no-swizzle
core-matrix layout its ``wgmma`` descriptors address: element (k, n) of
the chunk at ``(n // 8) * (KC // 8) * 64 + (k // 8) * 64 + (n % 8) * 8 +
k % 8``.  These tests pin that layout with an independent index formula,
the round trip through ``unpack_weights`` bit for bit, the host plan
against the kernel source's ``Plan<C>`` table, and ``FusedBottleneck``'s
packed buffers through ``.to()``.
"""

import os
import re

import numpy as np
import pytest
import torch

from glsdet_tpu_torch.models.resnet import Bottleneck
from glsdet_tpu_torch.ops import bottleneck_kernel as bk
from glsdet_tpu_torch.ops.fused_infer import FusedBottleneck

CU = os.path.join(os.path.dirname(bk.__file__), os.pardir, "csrc",
                  "bottleneck.cu")


def _weights(c, seed=0):
    """bf16 w1 (4C, C), w2 (9C, C), w3 (C, 4C) with distinct values."""
    rs = np.random.RandomState(seed + c)
    return [torch.from_numpy(rs.randn(k, n).astype(np.float32)).to(
        torch.bfloat16) for k, n in ((4 * c, c), (9 * c, c), (c, 4 * c))]


@pytest.mark.parametrize("c", bk.KERNEL_C)
def test_pack_unpack_round_trip_is_exact(c):
    ws = _weights(c)
    packed = bk.pack_weights(*ws)
    for p, w in zip(packed, ws):
        assert p.dtype == torch.bfloat16 and p.dim() == 1
        assert p.numel() == w.numel() and p.is_contiguous()
    for got, want in zip(bk.unpack_weights(*packed, c), ws):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("c", bk.KERNEL_C)
def test_chunks_are_contiguous_aligned_and_core_matrix_laid_out(c):
    """Every element sits where the kernel's address arithmetic looks for
    it, and every chunk starts 16-byte aligned."""
    ws = _weights(c, seed=1)
    packed = bk.pack_weights(*ws)
    for w, p, (kc, nch) in zip(ws, packed, bk.PLAN[c][2:]):
        k_all, n_all = w.shape
        kch = k_all // kc
        # the kernel copies chunk j from byte j * KC * NCH * 2 of the buffer
        assert (kc * nch * 2) % 16 == 0 and p.numel() == kc * nch * (
            kch * (n_all // nch))
        k, n = np.indices((k_all, n_all))
        j = (n // nch) * kch + k // kc
        kk, nn = k % kc, n % nch
        idx = (j * kc * nch + (nn // 8) * (kc // 8) * 64 + (kk // 8) * 64
               + (nn % 8) * 8 + kk % 8)
        want = w.view(torch.int16).numpy()
        got = p.view(torch.int16).numpy()[idx]
        np.testing.assert_array_equal(got, want)
        # a 16-deep K step is 256 bytes into the chunk
        assert kc % 16 == 0


def test_plan_matches_the_kernel_source():
    """``PLAN`` is the kernel's ``Plan<C>`` table (TH, CL, KC and NCH of
    each product): a packing the kernel would misread cannot ship."""
    with open(CU) as f:
        src = f.read()
    rows = re.findall(r"struct Plan<(\d+)>\s*\{\s*static constexpr int "
                      r"v\[\] = \{([^}]*)\}", src)
    assert sorted(int(c) for c, _ in rows) == sorted(bk.KERNEL_C)
    for c, vals in rows:
        v = [int(t) for t in vals.split(",")]
        assert bk.PLAN[int(c)] == (v[0], v[1], (v[2], v[3]), (v[5], v[6]),
                                   (v[8], v[9])), c
        # a conv2 chunk stays inside one 3x3 tap
        assert int(c) % v[5] == 0


def test_pack_rejects_what_the_kernel_cannot_take():
    ws = _weights(16)
    with pytest.raises(ValueError, match="C = 48"):
        bk.pack_weights(torch.zeros(192, 48), torch.zeros(432, 48),
                        torch.zeros(48, 192))
    with pytest.raises(ValueError, match="expected a"):
        bk.pack_weights(ws[0], ws[1][:-1], ws[2])


@pytest.fixture
def fused_block():
    block = Bottleneck(128, 32)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return FusedBottleneck(block.eval())


def test_fused_block_holds_packed_weights_through_to(fused_block):
    """The packed buffers are ``pack_weights`` of the folded bf16 weights,
    and stay bf16 whatever dtype the model is cast to."""
    m = fused_block
    for want, got in zip(bk.pack_weights(m.w1, m.w2, m.w3),
                         (m.w1p, m.w2p, m.w3p)):
        assert torch.equal(got, want)
    for cast in (lambda mod: mod.to(torch.float32),
                 lambda mod: mod.half(),
                 lambda mod: mod.to("cpu", torch.bfloat16)):
        cast(m)
        for name in ("w1p", "w2p", "w3p", "w1", "w2", "w3"):
            assert getattr(m, name).dtype == torch.bfloat16, name
        for name in ("b1", "b2", "b3"):
            assert getattr(m, name).dtype == torch.float32, name
    for got, want in zip(bk.unpack_weights(m.w1p, m.w2p, m.w3p, 32),
                         (m.w1, m.w2, m.w3)):
        assert torch.equal(got, want)


def test_wrapper_on_the_cpu_ignores_packed(fused_block):
    m = fused_block
    x = torch.relu(torch.randn(2, 8, 8, 128,
                               generator=torch.Generator().manual_seed(1)))
    ops = (m.w1, m.b1, m.w2, m.b2, m.w3, m.b3)
    want = bk.fused_bottleneck_plain(x, *ops)
    got = bk.fused_bottleneck(x, *ops, packed=(m.w1p, m.w2p, m.w3p))
    assert torch.equal(got, want)
