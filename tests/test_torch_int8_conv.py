"""Port parity: the int8 convolution (``glsdet_tpu_torch/ops/int8_conv.py``)
against XLA's ``conv_general_dilated(int8, int8,
preferred_element_type=int32)``, and the dynamic W8A8 convolution
(``ops/quant.py``) against ``glsdet_tpu.ops.quant.quantize_conv_output``,
on the CPU.

The int32 accumulators must be exactly equal: both are exact integer
sums.  The dynamic convolution has no int8 chain (one layer), so its
float32 output agrees to float32 rounding (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.ops.quant import quantize_conv_output
from glsdet_tpu_torch.ops.int8_conv import (Int8Conv2d, conv2d_int8,
                                            quantize_weight)
from glsdet_tpu_torch.ops.quant import DynamicQuantConv2d
from glsdet_tpu_torch.models.layers import Conv2d


def _codes(rs, shape):
    return rs.randint(-127, 128, shape).astype(np.int8)


def _xla(q_x, q_w_oihw, stride, pad, groups):
    y = jax.lax.conv_general_dilated(
        jnp.asarray(q_x), jnp.asarray(q_w_oihw.transpose(2, 3, 1, 0)),
        (stride, stride), [(pad, pad)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    return np.asarray(y)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("depthwise", [False, True])
def test_conv2d_int8_equals_xla(k, stride, pad, depthwise):
    rs = np.random.RandomState(k * 100 + stride * 10 + pad + 5 * depthwise)
    cin, cout = (24, 24) if depthwise else (20, 36)   # not multiples of 8
    groups = cin if depthwise else 1
    q_x = _codes(rs, (2, 11, 9, cin))
    q_w = _codes(rs, (cout, cin // groups, k, k))
    want = _xla(q_x, q_w, stride, pad, groups)
    got = conv2d_int8(torch.from_numpy(q_x.copy()),
                      torch.from_numpy(q_w.copy()), stride, pad, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_extreme_codes_accumulate_exactly():
    """|acc| up to 9 * 128 * 127**2: exact in the float64 product."""
    q_x = np.full((1, 4, 4, 128), -127, np.int8)
    q_w = np.full((8, 128, 3, 3), 127, np.int8)
    got = Int8Conv2d(torch.from_numpy(q_w), 1, 1)(torch.from_numpy(q_x))
    np.testing.assert_array_equal(got.numpy(), _xla(q_x, q_w, 1, 1, 1))
    assert int(got.min()) == -9 * 128 * 127 * 127


def test_quantize_weight_matches_the_jax_formula():
    w = np.random.RandomState(3).randn(16, 8, 3, 3).astype(np.float32)
    w[3] = 0.0                                    # all-zero channel: 1e-8
    k = jnp.asarray(w.transpose(2, 3, 1, 0))
    s_w = jnp.maximum(jnp.max(jnp.abs(k), axis=(0, 1, 2)), 1e-8) / 127.0
    q_w = np.asarray(jnp.round(k / s_w).astype(jnp.int8)).transpose(3, 2, 0, 1)
    got_q, got_s = quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got_q.numpy(), q_w)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(s_w))


@pytest.mark.parametrize("groups,stride,bias", [(1, 1, True), (1, 2, False),
                                                (64, 1, False)])
def test_dynamic_conv_matches_quantize_conv_output(groups, stride, bias):
    rs = np.random.RandomState(groups + stride)
    cin = cout = 64
    x = (rs.randn(2, 10, 12, cin) * rs.uniform(0.5, 3, (2, 1, 1, 1))
         ).astype(np.float32)
    w = (rs.randn(cout, cin // groups, 3, 3) * 0.05).astype(np.float32)
    b = (rs.randn(cout) * 0.1).astype(np.float32) if bias else None
    want = quantize_conv_output(
        jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
        None if b is None else jnp.asarray(b), strides=(stride, stride),
        padding=[(1, 1), (1, 1)], kernel_dilation=(1, 1),
        feature_group_count=groups, out_dtype=jnp.float32)
    conv = Conv2d(cin, cout, 3, stride, 1, groups=groups, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        if bias:
            conv.bias.copy_(torch.from_numpy(b))
    with torch.inference_mode():
        got = DynamicQuantConv2d(conv)(torch.from_numpy(x.copy())
                                       .permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
