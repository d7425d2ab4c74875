"""Port parity: the int8 convolution (``glsdet_tpu_torch/ops/int8_conv.py``)
against XLA's ``conv_general_dilated(int8, int8,
preferred_element_type=int32)``, and the dynamic W8A8 convolution
(``ops/quant.py``) against ``glsdet_tpu.ops.quant.quantize_conv_output``,
on the CPU, dilated convolutions included.

The int32 accumulators must be exactly equal: both are exact integer
sums.  The dynamic convolution has no int8 chain (one layer), so its
float32 output agrees to float32 rounding (rtol 1e-6).

On a whole model (YOLOX-nano with the ``lsk`` variant, whose 7x7
depthwise conv runs at dilation 3), ``quantize_dynamic`` must rewrite
exactly the convolutions that the JAX interceptor
(``glsdet_tpu.ops.quant.quantized_inference``) quantizes, by name, and
its detections must match the JAX package's eager int8 forward at the
int8 tolerances of tests/test_torch_two_stage_int8.py (same label, IoU >
0.5, scores within 0.1, >= 95% both ways).
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


def _xla(q_x, q_w_oihw, stride, pad, groups, dilation=1):
    y = jax.lax.conv_general_dilated(
        jnp.asarray(q_x), jnp.asarray(q_w_oihw.transpose(2, 3, 1, 0)),
        (stride, stride), [(pad, pad)] * 2,
        rhs_dilation=(dilation, dilation),
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


@pytest.mark.parametrize("dilation", [1, 2, 3])
@pytest.mark.parametrize("depthwise", [False, True])
def test_dilated_conv2d_int8_equals_xla(dilation, depthwise):
    """Taps ``dilation`` apart on both routes: the im2col + GEMM (dense)
    and the depthwise tap sum; the plain float64 product equals both."""
    rs = np.random.RandomState(10 * dilation + depthwise)
    cin, cout = (24, 24) if depthwise else (20, 36)
    groups = cin if depthwise else 1
    q_x = _codes(rs, (2, 13, 11, cin))
    q_w = _codes(rs, (cout, cin // groups, 3, 3))
    for stride, pad in ((1, dilation), (2, 0)):
        want = _xla(q_x, q_w, stride, pad, groups, dilation)
        conv = Int8Conv2d(torch.from_numpy(q_w.copy()), stride, pad, groups,
                          dilation)
        for plain in (False, True):
            got = conv(torch.from_numpy(q_x.copy()), plain=plain)
            np.testing.assert_array_equal(got.numpy(), want)


def test_lsk_dilated_depthwise_conv_equals_xla():
    """LSK's conv_spatial: 7x7 depthwise, dilation 3, padding 9."""
    rs = np.random.RandomState(7)
    q_x = _codes(rs, (1, 20, 20, 64))
    q_w = _codes(rs, (64, 1, 7, 7))
    got = conv2d_int8(torch.from_numpy(q_x.copy()),
                      torch.from_numpy(q_w.copy()), 1, 9, 64, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  _xla(q_x, q_w, 1, 9, 64, 3))


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


@pytest.mark.parametrize("groups,k,dilation", [(64, 7, 3), (1, 3, 2)])
def test_dilated_dynamic_conv_matches_quantize_conv_output(groups, k,
                                                           dilation):
    rs = np.random.RandomState(k + dilation)
    cin = cout = 64
    pad = dilation * (k // 2)
    x = (rs.randn(2, 16, 18, cin) * rs.uniform(0.5, 3, (2, 1, 1, 1))
         ).astype(np.float32)
    w = (rs.randn(cout, cin // groups, k, k) * 0.05).astype(np.float32)
    b = (rs.randn(cout) * 0.1).astype(np.float32)
    want = quantize_conv_output(
        jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b),
        strides=(1, 1), padding=[(pad, pad), (pad, pad)],
        kernel_dilation=(dilation, dilation), feature_group_count=groups,
        out_dtype=jnp.float32)
    conv = Conv2d(cin, cout, k, 1, pad, groups=groups, dilation=dilation)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        conv.bias.copy_(torch.from_numpy(b))
    with torch.inference_mode():
        got = DynamicQuantConv2d(conv)(torch.from_numpy(x.copy())
                                       .permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


def _jax_quantized_names(jmodel, variables, x):
    """The flax paths of the convolutions that ``quantized_inference``
    quantizes in an eager forward of ``jmodel``, and the outputs."""
    import flax.linen as fnn

    import glsdet_tpu.ops.quant as jquant

    stack, names = [], []

    def outer(next_fun, args, kwargs, context):
        if (type(context.module) is fnn.Conv
                and context.method_name == "__call__"):
            stack.append(".".join(context.module.path))
            try:
                return next_fun(*args, **kwargs)
            finally:
                stack.pop()
        return next_fun(*args, **kwargs)

    real = jquant.quantize_conv_output

    def recorded(*args, **kwargs):
        names.append(stack[-1])
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jquant, "quantize_conv_output", recorded)
        with fnn.intercept_methods(outer), jquant.quantized_inference():
            out = jmodel.apply(variables, x, train=False)
    return names, out


def _matched(a, b):
    """Share of a's detections with a partner in b: same label, IoU >
    0.5, |score difference| < 0.1."""
    if not len(a["boxes"]):
        return 1.0
    hits = 0
    for box, s, lab in zip(a["boxes"], a["scores"], a["labels"]):
        o = b["boxes"][(b["labels"] == lab) & (np.abs(b["scores"] - s) < 0.1)]
        lt = np.maximum(o[:, :2], box[:2])
        rb = np.minimum(o[:, 2:], box[2:])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
        area = lambda v: np.prod(v[..., 2:] - v[..., :2], axis=-1)  # noqa
        iou = inter / np.maximum(area(o) + area(box) - inter, 1e-9)
        hits += int((iou > 0.5).any())
    return hits / len(a["boxes"])


def test_lsk_coarse_det_dynamic_int8_matches_jax():
    """coarse_det with variant="lsk" at phi nano under dynamic int8: the
    same convolutions quantized (LSK's dilated ones among them) and the
    same detections as the JAX package's ``quantized_inference``."""
    from glsdet_tpu.eval.postprocess import yolox_postprocess as jpost
    from glsdet_tpu.models import YOLOXDetector as JYOLOX
    from glsdet_tpu_torch.eval.postprocess import yolox_postprocess
    from glsdet_tpu_torch.models import YOLOXDetector
    from glsdet_tpu_torch.ops.quant import quantize_dynamic
    from torch_port_util import flax_vars, load_flax, nchw, rand_nhwc

    jm = JYOLOX(num_classes=10, phi="nano", variant="lsk")
    x = rand_nhwc((2, 64, 64, 3), seed=1)
    variables = flax_vars(jm, x)
    names, (cls, reg, obj) = _jax_quantized_names(jm, variables, x.copy())
    port = quantize_dynamic(load_flax(
        YOLOXDetector(10, "nano", "lsk", generator=torch.Generator()),
        variables), device="cpu")
    got = sorted(n for n, m in port.named_modules()
                 if isinstance(m, DynamicQuantConv2d))
    assert {n for n in names if ".conv_spatial" in n} == {
        f"lsk{i}.lsk.conv_spatial" for i in range(3)}
    assert got == sorted(names)
    kw = dict(score_thr=0.01, iou_thr=0.65, max_dets=100)
    want = jpost(cls, reg, obj, (64, 64), **kw)
    with torch.inference_mode():
        d = yolox_postprocess(*port(nchw(x)), (64, 64), **kw)
    total = 0
    for i in range(2):
        w = {k: np.asarray(want[k][i])[np.asarray(want["valid"][i])]
             for k in ("boxes", "scores", "labels")}
        v = d["valid"][i].numpy()
        g = {k: d[k][i].numpy()[v] for k in ("boxes", "scores", "labels")}
        total += len(g["boxes"])
        assert _matched(g, w) >= 0.95 and _matched(w, g) >= 0.95
    assert total > 0
