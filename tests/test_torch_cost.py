"""``TwoStagePipeline.cost_analysis`` (``eval/cost.py`` over
``ops/cost.py``), on the CPU.

``flops`` is the model's work: it must equal ``FlopCounterMode``'s count
of the same float forwards exactly, and be the same for the float and
the static-int8 MP-Det (the CPU's float64 int8 route, its weights padded
to multiples of 8), and for the float and the fused MP-Det at depth 50
(whose identity bottlenecks the fused copy replaces).  The counts that
stand in
for what dispatch cannot see are pinned to ``FlopCounterMode`` too: an
``Int8Conv2d``'s 2 x MACs to the float convolution's, kernel B4's 34 C^2
a pixel to its plain version's products.  ``bytes`` depends on the route
and is only checked to be counted.

Against the JAX pipeline's ``cost_analysis`` (XLA's count) at the same
shapes the ratios are stated, not equal: XLA leaves out the taps of a
convolution that fall on its zero padding (296.26 M against 2 x MACs'
301.99 M for one 64x64x64 3x3 convolution with ReLU) and counts
elementwise work; at test size the coarse stage's is most of it (the
antialiased resize is a product there, and the decode and NMS of a
YOLOX-nano at 64x64 outweigh its 24 M of convolutions: JAX / port =
1.89), while MP-Det's small maps lose padded taps (0.90).

Pipelines: seeded YOLOX-nano at 64x64 and MP-Det-18 (50 for the fused
copy), buckets (128, 256), frames of 96x160, analysed at batch 1.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from torch.utils.flop_counter import FlopCounterMode

from glsdet_tpu.eval.two_stage import TwoStagePipeline as JPipeline
from glsdet_tpu.models import MPDet as JMPDet
from glsdet_tpu.models import YOLOXDetector as JYOLOX
from glsdet_tpu_torch.eval.two_stage import TwoStagePipeline
from glsdet_tpu_torch.models import MPDet, YOLOXDetector
from glsdet_tpu_torch.ops import cost
from glsdet_tpu_torch.ops.bottleneck_kernel import fused_bottleneck_plain
from glsdet_tpu_torch.ops.fused_infer import wrap_model_fused
from glsdet_tpu_torch.ops.int8_conv import Int8Conv2d, quantize_weight
from torch_tools_util import variable_shapes

FRAME = (96, 160)
KW = dict(coarse_score_thr=1e-4, mosaic_buckets=(128, 256), max_batch=2,
          pack_mode="bucket-fit", pack_threads=1, device="cpu")


def models(depth):
    g = torch.Generator().manual_seed(0)
    return (YOLOXDetector(10, "nano", generator=g),
            MPDet(10, depth, generator=g))


def flop_count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        with torch.inference_mode():
            fn()
    return counter.get_total_flops()


def analyse(coarse, mp, **kw):
    pipe = TwoStagePipeline(coarse, mp, (64, 64), **kw, **KW)
    try:
        return pipe.cost_analysis(FRAME, batch=1)
    finally:
        pipe.close()


@pytest.fixture(scope="module")
def costs():
    """cost_analysis of the serving modes: float and static int8 at depth
    18, float and fused at depth 50."""
    pipe = TwoStagePipeline(*models(18), (64, 64), **KW)
    frame = np.random.RandomState(0).randint(0, 256, (*FRAME, 3), np.uint8)
    try:
        out = {"float": pipe.cost_analysis(FRAME, batch=1)}
        scales = pipe.calibrate_int8([frame])
    finally:
        pipe.close()
    out["static"] = analyse(*models(18), quant8="static", act_scales=scales)
    coarse, mp = models(50)
    fused = wrap_model_fused(copy.deepcopy(mp))
    out["float50"] = analyse(copy.deepcopy(coarse), mp)
    out["fused50"] = analyse(coarse, fused)
    return out


def test_flops_are_flop_counter_modes_of_the_float_forwards(costs):
    got = costs["float"]
    assert (got["batch"], got["bucket"]) == (1, 128)
    coarse, mp = models(18)
    want_coarse = flop_count(lambda: coarse.eval()(torch.zeros(1, 3, 64,
                                                               64)))
    want_mp = flop_count(lambda: mp.eval()(torch.zeros(1, 3, 128, 128)))
    assert got["coarse"]["flops"] == want_coarse > 0
    assert got["stage2"]["flops"] == want_mp > 0


def test_flops_are_the_same_for_every_route(costs):
    for stage in ("coarse", "stage2"):
        for modes in (("float", "static"), ("float50", "fused50")):
            flops = {m: costs[m][stage]["flops"] for m in modes}
            assert len(set(flops.values())) == 1, (stage, flops)
        assert all(c[stage]["bytes"] > 0 for c in costs.values())
        for mode in ("float", "float50", "fused50"):
            assert costs[mode][stage]["int8_flop_frac"] == 0.0
        assert costs["static"][stage]["int8_flop_frac"] > 0.5
    assert costs["float50"]["stage2"]["flops"] > costs["float"]["stage2"][
        "flops"]
    # the int8 route and the fused copy move other bytes
    for a, b in (("static", "float"), ("fused50", "float50")):
        assert costs[a]["stage2"]["bytes"] != costs[b]["stage2"]["bytes"]


@pytest.mark.parametrize("cin,cout,k,stride,pad,dil,groups", [
    (3, 16, 3, 2, 1, 1, 1),       # the stem: K = 27 padded to 32
    (16, 24, 1, 1, 0, 1, 1),
    (16, 16, 3, 1, 3, 3, 1),      # dilated, as LSK's
    (16, 16, 3, 1, 1, 1, 16),     # depthwise
])
def test_int8_conv_counts_the_float_convolutions_products(cin, cout, k,
                                                          stride, pad, dil,
                                                          groups):
    rs = np.random.RandomState(0)
    w = torch.from_numpy(rs.randn(cout, cin // groups, k, k).astype(
        np.float32))
    x = torch.from_numpy(rs.randn(2, cin, 13, 11).astype(np.float32))
    conv = Int8Conv2d(quantize_weight(w)[0], stride, pad, groups, dil)
    q_x = torch.from_numpy(rs.randint(-127, 128, (2, 13, 11, cin)).astype(
        np.int8))
    with cost.count_cost() as counter:
        conv(q_x)
    want = flop_count(lambda: F.conv2d(x, w, None, stride, pad, dil, groups))
    assert counter.flops == counter.int8_flops == want


def test_b4_reports_its_plain_versions_products():
    """What the wrapper reports where it launches the kernel, 34 C^2 a
    pixel, is the product count of its plain version."""
    rs = np.random.RandomState(0)
    b, h, w, c = 2, 6, 8, 16
    x = torch.from_numpy(rs.randn(b, h, w, 4 * c).astype(np.float32))
    ws = [torch.from_numpy(rs.randn(*s).astype(np.float32))
          for s in ((4 * c, c), (c,), (9 * c, c), (c,), (c, 4 * c),
                    (4 * c,))]
    assert flop_count(lambda: fused_bottleneck_plain(x, *ws)) == (
        34 * c * c * b * h * w)


def test_nothing_is_counted_outside_count_cost():
    assert cost.current() is None
    cost.report(1e9, 1e9)                       # a launch, no counter
    with cost.count_cost() as outer:
        torch.ones(4) + 1
        with cost.count_cost() as inner:
            cost.report(10, 20)
        assert cost.current() is outer
    assert cost.current() is None
    assert (inner.bytes, inner.flops) == (10, 20)
    # ones: 16 bytes written; the add: 16 read, 16 written
    assert outer.bytes == 3 * 16 and outer.flops == 0


def test_against_the_jax_pipelines_cost_analysis(costs):
    """Ratios JAX / port at the same shapes (module docstring)."""
    jc, jm = JYOLOX(num_classes=10, phi="nano"), JMPDet(num_classes=10,
                                                        depth=18)

    def zeros(model):
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                            variable_shapes(model, (1, 64, 64, 3)))

    kw = dict(coarse_score_thr=1e-4, mosaic_buckets=(128, 256),
              max_batch=2)
    jpipe = JPipeline(lambda v, im: jc.apply(v, im, train=False),
                      lambda v, im: jm.apply(v, im, train=False), (64, 64),
                      coarse_vars=zeros(jc), mp_vars=zeros(jm),
                      mosaic_dtype=jnp.float32, pack_threads=1, **kw)
    want = jpipe.cost_analysis(FRAME, batch=1)
    got = costs["float"]
    assert (got["batch"], got["bucket"]) == (want["batch"], want["bucket"])
    coarse = want["coarse"]["flops"] / got["coarse"]["flops"]
    stage2 = want["stage2"]["flops"] / got["stage2"]["flops"]
    assert 1.7 < coarse < 2.1, coarse          # measured 1.893
    assert 0.85 < stage2 < 0.95, stage2        # measured 0.901

    class ConvReLU(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jax.nn.relu(fnn.Conv(64, (3, 3), padding="SAME")(x))

    x = jnp.zeros((1, 64, 64, 64), jnp.float32)
    v = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                     jax.eval_shape(ConvReLU().init, jax.random.PRNGKey(0),
                                    x))
    xla = jax.jit(ConvReLU().apply).lower(v, x).compile().cost_analysis()
    conv = torch.nn.Conv2d(64, 64, 3, padding=1)
    with cost.count_cost() as counter:
        with torch.inference_mode():
            torch.relu(conv(torch.zeros(1, 64, 64, 64)))
    assert counter.flops == 2 * 64 * 64 * 64 * 64 * 9      # 301.99 M
    assert 0.97 < xla["flops"] / counter.flops < 0.99     # 296.26 M
