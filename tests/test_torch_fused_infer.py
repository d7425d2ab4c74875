"""Port parity: serving-time fused bottlenecks
(``glsdet_tpu_torch/ops/fused_infer.py: wrap_model_fused``) against the
JAX package's interceptor (``glsdet_tpu/ops/fused_infer.py``), on the CPU.

The JAX models are applied eagerly under ``fused_bottleneck_inference()``
(the Pallas kernel in interpret mode); the port runs the kernel's plain
version.  Both round x, the folded weights and the intermediates to bf16
and sum in float32, so they differ by the order of the float32 sums: a
bf16 intermediate may round to its other neighbour, and such flips add up
over a dozen blocks.  Bound: relative max error (max |port - jax| / max
|jax|) <= 1e-2 per output.

At 64x64 input the stages run at 16, 8, 4 and 2 pixels: layer1 and
layer2 fire, layer3 and layer4 fall through (W < 8), in both packages.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.models import MPDet as JMPDet
from glsdet_tpu.models import ResNet as JResNet
from glsdet_tpu.ops.fused_infer import fused_bottleneck_inference
from glsdet_tpu_torch.models import MPDet
from glsdet_tpu_torch.models.resnet import ResNet
from glsdet_tpu_torch.ops import bottleneck_kernel
from glsdet_tpu_torch.ops.fused_infer import FusedBottleneck, wrap_model_fused
from torch_port_util import flax_vars, load_flax, nchw, rand_nhwc


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module")
def resnet():
    """(JAX ResNet-50 outputs under the interceptor, port ResNet-50 with
    the same weights, unwrapped, the input) at base width 16, 64x64."""
    jm = JResNet(depth=50, base_channels=16)
    x = rand_nhwc((2, 64, 64, 3), seed=3)
    variables = flax_vars(jm, x)
    with fused_bottleneck_inference():
        want = jm.apply(jax.device_put(variables), jnp.asarray(x.copy()),
                        train=False)
    port = load_flax(ResNet(50, base_channels=16), variables)
    return [np.asarray(w) for w in want], port, x


def test_resnet_fused_matches_jax(resnet):
    want, port, x = resnet
    model = wrap_model_fused(copy.deepcopy(port))
    n_fused = sum(isinstance(m, FusedBottleneck) for m in model.modules())
    assert n_fused == 12                     # 2 + 3 + 5 + 2 identity blocks
    before = bottleneck_kernel.launches
    with torch.inference_mode():
        got = model(nchw(x))
    assert bottleneck_kernel.launches == before   # the CPU takes the plain
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1)
        assert tuple(g.shape) == w.shape
        assert _rel(g, w) <= 1e-2


def test_fused_path_fires(resnet):
    """layer1 and layer2 differ from the unfused float32 port (the fused
    blocks round to bf16); layer3 and layer4 are not all equal either,
    since their input changed."""
    _, port, x = resnet
    model = wrap_model_fused(copy.deepcopy(port))
    with torch.inference_mode():
        got, ref = model(nchw(x)), port(nchw(x))
    for g, r in zip(got[:2], ref[:2]):
        assert float((g - r).abs().max()) > 0


@pytest.mark.parametrize("case", ["train", "depth18", "odd_h"])
def test_falls_through_equal_to_unfused(resnet, case):
    _, port, x = resnet
    if case == "depth18":
        port = load_flax(ResNet(18, base_channels=16),
                         flax_vars(JResNet(depth=18, base_channels=16), x))
    ref = copy.deepcopy(port)
    model = wrap_model_fused(copy.deepcopy(port))
    if case == "depth18":
        assert not any(isinstance(m, FusedBottleneck)
                       for m in model.modules())
    inp = nchw(rand_nhwc((2, 68, 64, 3), seed=4) if case == "odd_h" else x)
    if case == "train":                 # BN in training mode, stats update
        model.train()
        ref.train()
        got, want = model(inp), ref(inp)
    else:
        with torch.inference_mode():
            got, want = model(inp), ref(inp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_folded_biases_stay_float32_through_to(resnet):
    _, port, _ = resnet
    model = wrap_model_fused(copy.deepcopy(port)).to(torch.bfloat16)
    fused = [m for m in model.modules() if isinstance(m, FusedBottleneck)]
    assert len(fused) == 12
    for m in fused:
        assert m.block.conv1.conv.weight.dtype == torch.bfloat16
        for name in ("b1", "b2", "b3"):
            assert getattr(m, name).dtype == torch.float32
        for name in ("w1", "w2", "w3"):
            assert getattr(m, name).dtype == torch.bfloat16
    # and the float32 values themselves survived: equal to a fresh fold
    fresh = wrap_model_fused(copy.deepcopy(port))
    for a, b in zip(fused, (m for m in fresh.modules()
                            if isinstance(m, FusedBottleneck))):
        assert torch.equal(a.b2, b.b2)


def test_mpdet_fused_matches_jax():
    jm = JMPDet(num_classes=10, depth=50)
    x = rand_nhwc((1, 64, 64, 3), seed=5)
    variables = flax_vars(jm, x)
    with fused_bottleneck_inference():
        cls_w, reg_w = jm.apply(jax.device_put(variables),
                                jnp.asarray(x.copy()), train=False)
    model = wrap_model_fused(load_flax(MPDet(10, 50, generator=torch.
                                             Generator().manual_seed(0)),
                                       variables))
    with torch.inference_mode():
        cls_g, reg_g = model(nchw(x))
    for g, w in zip(list(cls_g) + list(reg_g), list(cls_w) + list(reg_w)):
        assert tuple(g.shape) == w.shape
        assert _rel(g, w) <= 1e-2
