"""Port parity: conv+BN folding (``glsdet_tpu_torch/models/fuse.py``)
against ``glsdet_tpu/models/fuse.py``, on the CPU.

YOLOX-nano (depthwise convolutions included) and MPDet depth 18, with the
same flax weights (BN statistics perturbed, so the fold is not trivial):
the port folds as many pairs as the JAX package; the folded port's
outputs agree with the unfolded port's to rtol = atol = 1e-5 in float32;
and the folded state equals ``state_dict_from_flax`` of the JAX-folded
variables to 1e-6.
"""

import copy

import numpy as np
import pytest
import torch

from glsdet_tpu.models import MPDet as JMPDet
from glsdet_tpu.models import YOLOXDetector as JYOLOX
from glsdet_tpu.models.fuse import fuse_conv_bn as jax_fuse_conv_bn
from glsdet_tpu_torch.models import MPDet, YOLOXDetector
from glsdet_tpu_torch.models.fuse import fuse_conv_bn
from glsdet_tpu_torch.utils.flax_import import state_dict_from_flax
from torch_port_util import flax_vars, load_flax, nchw, rand_nhwc

MODELS = {
    "yolox_nano": (lambda: JYOLOX(num_classes=10, phi="nano"),
                   lambda g: YOLOXDetector(10, "nano", generator=g)),
    "mpdet18": (lambda: JMPDet(num_classes=10, depth=18),
                lambda g: MPDet(10, 18, generator=g)),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def folded(request):
    jmake, tmake = MODELS[request.param]
    x = rand_nhwc((1, 64, 64, 3), seed=7)
    variables = flax_vars(jmake(), x)
    port = load_flax(tmake(torch.Generator().manual_seed(0)), variables)
    model, n = fuse_conv_bn(copy.deepcopy(port))
    return variables, port, model, n, x


def test_folds_as_many_pairs_as_jax(folded):
    variables, _, _, n, _ = folded
    _, n_jax = jax_fuse_conv_bn(variables)
    assert n == n_jax > 0


def test_outputs_unchanged_by_folding(folded):
    _, port, model, _, x = folded
    with torch.inference_mode():
        want, got = port(nchw(x)), model(nchw(x))
    for g_maps, w_maps in zip(got, want):
        for g, w in zip(g_maps, w_maps):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_folded_state_equals_jax_folded(folded):
    variables, _, model, _, _ = folded
    want = state_dict_from_flax(jax_fuse_conv_bn(variables)[0])
    got = model.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
