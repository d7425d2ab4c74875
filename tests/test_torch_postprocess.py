"""Port parity: ``yolox_postprocess`` / ``gfl_postprocess`` vs the JAX
package, fed the same raw head maps (numpy, seeded).

valid and labels exact; boxes atol 1e-4 (exp / softmax-expectation decode
in another summation order); scores atol 1e-6 (sigmoid).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.eval import postprocess as jpp
from glsdet_tpu_torch.eval import postprocess as tpp


def _compare(got, want):
    for key in ("valid", "labels"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    v = got["valid"].numpy()
    assert v.any()
    np.testing.assert_allclose(got["boxes"].numpy()[v],
                               np.asarray(want["boxes"])[v], atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-6)


def _maps(rs, b, hw, strides, chans, loc=0.0):
    return [(loc + rs.randn(b, -(-hw[0] // s), -(-hw[1] // s), chans))
            .astype(np.float32) for s in strides]


@pytest.mark.parametrize("thr", [1e-4, 0.01])
def test_yolox_postprocess_matches(thr):
    rs = np.random.RandomState(0)
    hw, strides, b = (64, 96), (8, 16, 32), 2
    cls = _maps(rs, b, hw, strides, 10, loc=-4.6)
    reg = _maps(rs, b, hw, strides, 4)
    obj = _maps(rs, b, hw, strides, 1, loc=-4.6)
    t = [[torch.from_numpy(m.copy()) for m in ms] for ms in (cls, reg, obj)]
    j = [[jnp.asarray(m.copy()) for m in ms] for ms in (cls, reg, obj)]
    got = tpp.yolox_postprocess(*t, hw, score_thr=thr, max_dets=200)
    want = jpp.yolox_postprocess(*j, hw, score_thr=thr, max_dets=200)
    _compare(got, want)


@pytest.mark.parametrize("mode", ["all", "cls", "obj", "none"])
def test_yolox_postprocess_apply_sigmoid_matches(mode):
    """The loss ablations' heads: a map the decode does not pass through
    a sigmoid is already a probability (raw values in [0, 0.3) here)."""
    rs = np.random.RandomState(1)
    hw, strides, b = (64, 96), (8, 16, 32), 2

    def head(chans, sigmoid):
        if sigmoid:
            return _maps(rs, b, hw, strides, chans, loc=-2.0)
        return [(0.3 * rs.rand(*m.shape)).astype(np.float32)
                for m in _maps(rs, b, hw, strides, chans)]

    cls = head(10, mode in ("all", "cls"))
    reg = _maps(rs, b, hw, strides, 4)
    obj = head(1, mode in ("all", "obj"))
    t = [[torch.from_numpy(m.copy()) for m in ms] for ms in (cls, reg, obj)]
    j = [[jnp.asarray(m.copy()) for m in ms] for ms in (cls, reg, obj)]
    got = tpp.yolox_postprocess(*t, hw, score_thr=0.01, max_dets=200,
                                apply_sigmoid=mode)
    want = jpp.yolox_postprocess(*j, hw, score_thr=0.01, max_dets=200,
                                 apply_sigmoid=mode)
    _compare(got, want)
    with pytest.raises(ValueError):
        tpp.yolox_postprocess(*t, hw, apply_sigmoid="both")


@pytest.mark.parametrize("max_dets,nms_pre", [(100, 1000), (500, 64)])
def test_gfl_postprocess_matches(max_dets, nms_pre):
    rs = np.random.RandomState(max_dets)
    hw, strides, b = (128, 128), (8, 16, 32, 64, 128), 2
    cls = _maps(rs, b, hw, strides, 10, loc=-3.0)
    reg = _maps(rs, b, hw, strides, 68)
    t_cls = [torch.from_numpy(m.copy()) for m in cls]
    t_reg = [torch.from_numpy(m.copy()) for m in reg]
    got = tpp.gfl_postprocess(t_cls, t_reg, hw, score_thr=0.01,
                              max_dets=max_dets, nms_pre=nms_pre)
    want = jpp.gfl_postprocess([jnp.asarray(m.copy()) for m in cls],
                               [jnp.asarray(m.copy()) for m in reg], hw,
                               score_thr=0.01, max_dets=max_dets,
                               nms_pre=nms_pre)
    _compare(got, want)
