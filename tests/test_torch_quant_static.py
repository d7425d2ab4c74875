"""Port parity: static-int8 calibration and serving
(``glsdet_tpu_torch/ops/quant_static.py`` vs ``glsdet_tpu/ops/quant_static.py``),
on the CPU in float32.

Same flax weights (``torch_port_util.flax_vars``) and seeded inputs on
both sides.  The JAX side runs eagerly (``apply`` outside ``jit``), as the
JAX package's own tests of this module do: under ``jit`` XLA rewrites the
float32 epilogues (a division by a constant scale, fused multiply-adds),
which moves values by an ulp, and in an int8 chain one code that flips at
a rounding boundary changes about w * s_in / s_out of a code in each of
the next convolution's 9 * C outputs, so flips multiply layer by layer
(measured: JAX jitted vs JAX eager on an MPDet-18 at 2x128x128 differ by
up to 8% of the output maximum).  Eagerly, XLA and PyTorch run the same
float32 operations one by one, and the port must give the same codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.models import MPDet as JMPDet
from glsdet_tpu.models import ResNet as JResNet
from glsdet_tpu.models import YOLOXDetector as JYOLOX
from glsdet_tpu.models.layers import ConvNormAct as JConvNormAct
from glsdet_tpu.ops import quant_static as jq
from glsdet_tpu_torch.models import MPDet, YOLOXDetector
from glsdet_tpu_torch.models.layers import ConvNormAct
from glsdet_tpu_torch.models.resnet import ResNet
from glsdet_tpu_torch.ops import quant_static as tq
from torch_port_util import flax_vars, load_flax, nchw, to_np

# name -> (JAX model, port model factory, min_channels, input NHWC shape)
MODELS = {
    "yolox_nano": (lambda: JYOLOX(num_classes=10, phi="nano"),
                   lambda g: YOLOXDetector(10, "nano", generator=g), 32,
                   (2, 64, 64, 3)),
    # min_channels 16 at base width 16: every scale of the explicit int8
    # ResNet-50 forward is recorded, so that path runs
    "resnet50_b16": (lambda: JResNet(depth=50, base_channels=16),
                     lambda g: ResNet(50, 16), 16, (2, 32, 32, 3)),
    "mpdet18": (lambda: JMPDet(num_classes=10, depth=18),
                lambda g: MPDet(10, 18, generator=g), 32, (1, 64, 64, 3)),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    jfac, tfac, min_ch, shape = MODELS[request.param]
    jm = jfac()
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    v = flax_vars(jm, x)
    fn = lambda vv, im: jm.apply(vv, im, train=False)  # noqa: E731
    scales = jq.calibrate_scales(fn, v, [jnp.asarray(x.copy())],
                                 min_channels=min_ch)
    tm = load_flax(tfac(torch.Generator().manual_seed(0)), v)
    return request.param, fn, v, tm, x, scales, min_ch


def _leaves(out):
    return [to_np(a) for a in jax.tree_util.tree_leaves(out)]


def test_calibration_keys_and_values(case):
    _, _, _, tm, x, want, min_ch = case
    got = tq.calibrate_scales(tm, [nchw(x)], min_channels=min_ch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_same_scales_same_codes(case):
    """The JAX package's scales fed to both: outputs within 1e-3 of
    max|JAX output|; for the explicit int8 ResNet-50, whose stage outputs
    are int8 codes times the block scale, the codes themselves: equal on
    >= 99.9% of elements and within +-1 everywhere."""
    name, fn, v, tm, x, scales, min_ch = case
    with jq.static_quant_inference(scales, min_channels=min_ch):
        want = _leaves(fn(v, jnp.asarray(x.copy())))
    qm = tq.quantize_static(tm, scales, min_channels=min_ch, device="cpu")
    with torch.inference_mode():
        got = _leaves(qm(nchw(x)))
    assert len(got) == len(want)
    if name == "resnet50_b16":
        assert type(qm) is tq.Int8ResNet
        got = [g.transpose(0, 2, 3, 1) for g in got]
        for stage, (g, w) in enumerate(zip(got, want)):
            n = len(tm.names[stage])
            s = scales[f"layer{stage + 1}_{n - 1}.out"]
            d = np.abs(np.round(g / s) - np.round(w / s))
            assert d.max() <= 1 and (d == 0).mean() >= 0.999
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()


def test_missing_scales_leave_the_model_unchanged(case):
    _, _, _, tm, x, _, min_ch = case
    qm = tq.quantize_static(tm, {}, min_channels=min_ch, device="cpu")
    with torch.inference_mode():
        want = _leaves(tm(nchw(x)))
        got = _leaves(qm(nchw(x)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("norm,act,stride", [("bn", "silu", 1),
                                             ("bn", "relu", 2),
                                             ("gn", "relu", 1),
                                             (None, "lrelu", 1)])
def test_conv_norm_act_module(norm, act, stride):
    """One ``ConvNormAct`` through the per-module rewrite
    (``_quant_module_call``): no chain, so the output codes agree."""
    cin, cout = 48, 64
    jm = JConvNormAct(cout, 3, stride, norm=norm, act=act)
    x = np.random.RandomState(1).randn(2, 12, 10, cin).astype(np.float32)
    v = flax_vars(jm, x)
    fn = lambda vv, im: jm.apply(vv, im, train=False)  # noqa: E731
    scales = jq.calibrate_scales(fn, v, [jnp.asarray(x.copy())])
    assert set(scales) == {".in", ".out"}
    with jq.static_quant_inference(scales):
        want = np.asarray(fn(v, jnp.asarray(x.copy())))
    tm = load_flax(ConvNormAct(cin, cout, 3, stride, norm=norm, act=act), v)
    assert tq.calibrate_scales(tm, [nchw(x)]).keys() == scales.keys()
    qm = tq.quantize_static(tm, scales, device="cpu")
    assert type(qm) is tq.QConvNormAct
    with torch.inference_mode():
        got = to_np(qm(nchw(x))).transpose(0, 2, 3, 1)
    s = scales[".out"]
    d = np.abs(np.round(got / s) - np.round(want / s))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999


def test_scales_json_loads_in_both_packages(tmp_path):
    one = {"backbone/stem.out": 0.0123, "neck/lateral0.in": 0.5}
    pair = (one, {"head/cls_conv0.in": 0.25})
    for i, (save, load) in enumerate(((tq.save_scales, jq.load_scales),
                                      (jq.save_scales, tq.load_scales))):
        for j, scales in enumerate((one, pair)):
            path = str(tmp_path / f"s{i}{j}.json")
            save(path, scales)
            assert load(path) == scales
    bad = tmp_path / "bad.json"
    bad.write_text('{"format": "other", "scales": {}}')
    with pytest.raises(ValueError):
        tq.load_scales(str(bad))


@pytest.mark.parametrize("which", ["static", "dynamic"])
def test_quantizers_default_to_the_card(monkeypatch, which):
    """Without ``device`` both quantizers place their copy on the card,
    and without one they raise rather than return a CPU model."""
    from glsdet_tpu_torch.ops import quant

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = ConvNormAct(8, 8, 3)
    with pytest.raises(RuntimeError, match="no GPU"):
        if which == "static":
            tq.quantize_static(tm, {})
        else:
            quant.quantize_dynamic(tm)
