"""Port parity: the accumulator entry of GroupNorm -> ReLU -> int8 requant
(``glsdet_tpu_torch/ops/gn_kernel.py: gn_relu_quant_acc``, whose CUDA
kernel dequantizes the int8 convolution's int32 accumulator on load), on
the CPU.

- Its plain version is bit for bit the bf16 entry's plain version fed
  ``(acc.float() * deq).to(bfloat16)`` (and the float32 one fed the
  float32 product), and the CPU wrapper launches nothing.
- Against the JAX package's fused branch (``quant_static.py:568-575``):
  the port's ``deq`` equals JAX's ``s_cur * s_w``, and the codes are
  within +-1 of the Pallas kernel in interpret mode fed JAX's ``yq``, at
  most 1e-3 of them differing (the order of the f32 statistics sums).
- The rewired int8 tower (``ops/quant_static.py: _Int8Tower``) gives the
  same codes as the route it replaces (``QConv``'s float output, cast to
  the compute dtype, then the bf16 entry), in float32 and in bfloat16.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.ops.pallas_gn import gn_relu_quant as pallas_gn_relu_quant
from glsdet_tpu_torch.models.layers import ConvNormAct
from glsdet_tpu_torch.ops import gn_kernel
from glsdet_tpu_torch.ops import quant_static as tq
from glsdet_tpu_torch.ops.int8_conv import quantize_weight, requant


def _acc_inputs(shape, seed):
    """int32 accumulators of a 3x3 int8 convolution's magnitude (a few
    thousand, per-channel offsets), their dequantization scale as QConv
    builds it (``s_w * s_x``), and a GN affine."""
    rs = np.random.RandomState(seed)
    c = shape[-1]
    acc = (rs.randn(*shape) * rs.uniform(1500, 6000)
           + rs.randn(c) * 800).astype(np.int32)
    s_w = (rs.uniform(0.5, 2.0, c) / 127.0).astype(np.float32)
    s_x = float(rs.uniform(0.01, 0.05))
    gamma = rs.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (rs.randn(c) * 0.3).astype(np.float32)
    return acc, s_w, s_x, gamma, beta, float(rs.uniform(0.01, 0.1))


@pytest.mark.parametrize("shape", [(2, 9, 9, 256), (1, 16, 16, 128),
                                   (3, 5, 7, 64), (1, 3, 5, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_acc_plain_is_the_bf16_entry_on_the_dequantized_tensor(shape,
                                                               dtype):
    acc, s_w, s_x, gamma, beta, s_out = _acc_inputs(shape, sum(shape))
    acc_t = torch.from_numpy(acc)
    deq = torch.from_numpy(s_w) * s_x
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    groups = min(32, shape[-1])
    want = gn_kernel.gn_relu_quant_plain(
        (acc_t.float() * deq).to(dtype), g, b, s_out, groups)
    before = gn_kernel.launches
    for got in (gn_kernel.gn_relu_quant_acc_plain(acc_t, deq, g, b, s_out,
                                                  groups, dtype=dtype),
                gn_kernel.gn_relu_quant_acc(acc_t, deq, g, b, s_out, groups,
                                            dtype=dtype)):
        assert got.dtype == torch.int8 and torch.equal(got, want)
    assert gn_kernel.launches == before           # no kernel on the CPU
    assert (want != 0).float().mean() > 0.3       # not all clipped


@pytest.mark.parametrize("shape", [(1, 16, 16, 128), (2, 8, 24, 128),
                                   (1, 8, 8, 256)])
def test_acc_matches_the_pallas_kernel_on_jax_yq(shape):
    acc, s_w, s_x, gamma, beta, s_out = _acc_inputs(shape, 11 + sum(shape))
    # the JAX package's fused branch: yq = (y.f32 * (s_cur * s_w)).bf16
    deq_jax = np.asarray(s_x * jnp.asarray(s_w))
    deq = torch.from_numpy(s_w) * s_x
    np.testing.assert_array_equal(deq.numpy(), deq_jax)
    yq = (jnp.asarray(acc).astype(jnp.float32) * deq_jax).astype(jnp.bfloat16)
    want = np.asarray(pallas_gn_relu_quant(
        yq, jnp.asarray(gamma), jnp.asarray(beta), s_out, groups=32,
        interpret=True))
    got = gn_kernel.gn_relu_quant_acc(
        torch.from_numpy(acc), deq, torch.from_numpy(gamma),
        torch.from_numpy(beta), s_out, groups=32, eps=1e-6).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    assert (got != 0).mean() > 0.3


def _tower(seed, c, n_convs=2):
    """An int8 GN tower and the float ConvNormAct modules it was built
    from."""
    g = torch.Generator().manual_seed(seed)
    convs = []
    for _ in range(n_convs):
        m = ConvNormAct(c, c, 3, norm="gn", act="relu")
        with torch.no_grad():
            m.conv.weight.copy_(torch.randn(m.conv.weight.shape,
                                            generator=g) * 0.05)
            m.gn.weight.copy_(torch.rand(c, generator=g) + 0.5)
            m.gn.bias.copy_(torch.randn(c, generator=g) * 0.3)
        convs.append(m)
    return tq._Int8Tower(convs, 0.02, [0.015 + 0.005 * i
                                       for i in range(n_convs)]), convs


def _old_route(tower, x):
    """The tower as it ran before the accumulator entry: QConv's float32
    output, cast to the compute dtype, then the bf16 entry."""
    q = requant(tq._nhwc(x).float(), tower.s_in0)
    for i, (conv, s_out) in enumerate(zip(tower.convs, tower.s_outs)):
        y = conv(q).to(x.dtype)
        q = gn_kernel.gn_relu_quant(
            y.contiguous(), getattr(tower, f"gn_weight{i}"),
            getattr(tower, f"gn_bias{i}"), s_out, groups=tq.HEAD_GN_GROUPS,
            eps=tq.INT8_GN_EPS)
    return (q.float() * tower.s_outs[-1]).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c", [(12, 64), (9, 128)])
def test_int8_tower_gives_the_codes_of_the_old_route(dtype, hw, c):
    tower, _ = _tower(hw + c, c)
    x = torch.from_numpy(np.random.RandomState(hw).randn(2, c, hw, hw)
                         .astype(np.float32)).to(dtype)
    with torch.inference_mode():
        got, want = tower(x), _old_route(tower, x)
    assert got.dtype == dtype and torch.equal(got, want)
    assert (want != 0).float().mean() > 0.2


def test_deq_of_the_tower_is_s_w_times_s_x():
    """The scale the kernel dequantizes with is QConv's: quantize_weight's
    per-channel s_w times the conv's input scale, in float32."""
    tower, convs = _tower(3, 64)
    for qconv, m, s_in in zip(tower.convs, convs,
                              [tower.s_in0] + tower.s_outs[:-1]):
        _, s_w = quantize_weight(m.conv.weight.float())
        assert qconv.deq.dtype == torch.float32
        assert torch.equal(qconv.deq, s_w * s_in)
