"""Port parity: the variant zoo (``glsdet_tpu_torch.models.variants``)
against ``glsdet_tpu.models.variants``, class by class (the detectors
that use them: tests/test_torch_variant_detectors.py and
tests/test_torch_ffa.py).

Inputs are seeded numpy arrays at 8-32 channels and 8-32 px; flax
weights from ``init(PRNGKey(0))`` with the constant leaves jittered
(biases, norm scales, BN statistics), loaded through
``utils/flax_import.py`` with strict=True.  Float32 throughout; each
output within 1e-4 of the JAX output's max |value| (rtol 1e-4).  Modules
that only compute in training (BatchFormer) run in training mode without
dropout: JAX's dropout draws are not reproduced.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.models import variants as jv
from glsdet_tpu_torch.models import variants as tv
from glsdet_tpu_torch.models.layers import flax_init_
from torch_port_util import load_flax, rand_nhwc, to_np

TOL = 1e-4


def _jitter(variables, seed=1):
    rs = np.random.RandomState(seed)

    def jitter(path, a):
        name = path[-1].key
        if name == "var":
            return np.asarray(0.5 + rs.rand(*a.shape), np.float32)
        if name in ("mean", "bias"):
            return np.asarray(0.1 * rs.randn(*a.shape), np.float32)
        if name == "scale" and a.ndim == 1:
            return np.asarray(1.0 + 0.1 * rs.randn(*a.shape), np.float32)
        return a

    return jax.tree_util.tree_map_with_path(jitter, variables)


def _takes_train(jmod) -> bool:
    return "train" in inspect.signature(type(jmod).__call__).parameters


def _nchw(a):
    if isinstance(a, (list, tuple)):
        return [_nchw(t) for t in a]
    t = torch.from_numpy(np.array(a, np.float32))
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _nhwc(t):
    if isinstance(t, (list, tuple)):
        return [_nhwc(x) for x in t]
    return to_np(t.permute(0, 2, 3, 1) if t.dim() == 4 else t)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for t in x for y in _flat(t)]
    return [np.asarray(x)]


def run_pair(jmod, tmod, inputs, train=False, init_train=False):
    """JAX ``jmod`` and the port's ``tmod`` on the same NHWC ``inputs``
    (each an array or a list of arrays) and weights, initialised in
    training mode with ``init_train``; returns the pairs of NHWC
    outputs."""
    kw = {"train": train} if _takes_train(jmod) else {}
    ikw = {**kw, "train": init_train} if kw else {}
    jin = [jax.tree_util.tree_map(jnp.asarray, a) for a in inputs]
    variables = jax.device_get(jax.jit(
        lambda key, *a: jmod.init(key, *a, **ikw))(jax.random.PRNGKey(0),
                                                   *jin))
    variables = _jitter(jax.tree_util.tree_map(np.asarray, variables))
    want = jmod.apply(variables, *jin, **kw)
    load_flax(tmod, variables)
    tmod.train(train)
    with torch.no_grad():
        got = tmod(*[_nchw(a) for a in inputs])
    return list(zip(_flat(_nhwc(got)), _flat(want)))


def assert_pairs(pairs, tol=TOL):
    assert pairs
    for got, want in pairs:
        assert got.shape == want.shape
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def x(shape, seed=0):
    return rand_nhwc(shape, seed)


C = 16
CASES = {
    "SE": (lambda: jv.SE(), lambda: tv.SE(C), [x((2, 8, 8, C))]),
    "SEBlock": (lambda: jv.SEBlock(), lambda: tv.SEBlock(C),
                [x((2, 8, 8, C))]),
    "SEBlockFPN": (lambda: jv.SEBlockFPN(),
                   lambda: tv.SEBlockFPN((8, 16, 32)),
                   [[x((2, 16, 16, 8)), x((2, 8, 8, 16), 1),
                     x((2, 4, 4, 32), 2)]]),
    "SEAttention": (lambda: jv.SEAttention(channels=16),
                    lambda: tv.SEAttention(16), [x((2, 4, 4, 8))]),
    "MSCAM": (lambda: jv.MSCAM(), lambda: tv.MSCAM(C), [x((2, 8, 8, C))]),
    "ConAugModule": (lambda: jv.ConAugModule(out_channels=8),
                     lambda: tv.ConAugModule(C, 8), [x((2, 12, 12, C))]),
    "NonLocalBlock": (lambda: jv.NonLocalBlock(),
                      lambda: tv.NonLocalBlock(C), [x((2, 8, 8, C))]),
    "NonLocalBlock_gaussian": (
        lambda: jv.NonLocalBlock(mode="gaussian", inter_channels=4),
        lambda: tv.NonLocalBlock(C, mode="gaussian", inter_channels=4),
        [x((2, 8, 8, C))]),
    "PatchNonLocal": (lambda: jv.PatchNonLocal(patch=4),
                      lambda: tv.PatchNonLocal(C, patch=4),
                      [x((2, 8, 12, C))]),
    "PatchConvNonLocal": (
        lambda: jv.PatchConvNonLocal(out_channels=24),
        lambda: tv.PatchConvNonLocal(C, 24), [x((2, 16, 16, C))]),
    "PatchConvNonLocal_non_linear": (
        lambda: jv.PatchConvNonLocal(out_channels=24,
                                     channel_cat="non_linear"),
        lambda: tv.PatchConvNonLocal(C, 24, channel_cat="non_linear"),
        [x((2, 16, 16, C))]),
    "PatchNonLocalQuad": (
        lambda: jv.PatchNonLocalQuad(out_channels=24),
        lambda: tv.PatchNonLocalQuad(C, 24), [x((2, 16, 16, C))]),
    "PatchNonLocalQuad_linear": (
        lambda: jv.PatchNonLocalQuad(out_channels=24, channel_cat="linear"),
        lambda: tv.PatchNonLocalQuad(C, 24, channel_cat="linear"),
        [x((2, 16, 16, C))]),
    "PatchConvNonLocal44": (
        lambda: jv.PatchConvNonLocal44(out_channels=24),
        lambda: tv.PatchConvNonLocal44(C, 24), [x((2, 32, 32, C))]),
    "PatchConvNonLocalAdapt": (
        lambda: jv.PatchConvNonLocalAdapt(out_channels=24),
        lambda: tv.PatchConvNonLocalAdapt(C, 24), [x((2, 16, 16, C))]),
    "SpatialAttention": (lambda: jv.SpatialAttention(),
                         lambda: tv.SpatialAttention(), [x((2, 8, 8, C))]),
    "VANAttention": (lambda: jv.VANAttention(),
                     lambda: tv.VANAttention(C), [x((2, 8, 8, C))]),
    "LSKBlock": (lambda: jv.LSKBlock(), lambda: tv.LSKBlock(C),
                 [x((2, 24, 24, C))]),
    "LSKAttention": (lambda: jv.LSKAttention(), lambda: tv.LSKAttention(C),
                     [x((2, 24, 24, C))]),
    "LVCBlock": (lambda: jv.LVCBlock(num_codes=8),
                 lambda: tv.LVCBlock(C, num_codes=8), [x((2, 8, 8, C))]),
    "LightMLPBlock": (lambda: jv.LightMLPBlock(),
                      lambda: tv.LightMLPBlock(C), [x((2, 8, 8, C))]),
    "EVCBlock": (lambda: jv.EVCBlock(), lambda: tv.EVCBlock(C),
                 [x((2, 8, 8, C))]),
    "FFA": (lambda: jv.FFA(channels=8), lambda: tv.FFA(8, 16),
            [x((2, 16, 16, 8)), x((2, 8, 8, 16), 1)]),
    "FeatureGroup": (lambda: jv.FeatureGroup(),
                     lambda: tv.FeatureGroup(C), [x((2, 8, 8, C))]),
    "FeatureGroupFPN_cascade": (
        lambda: jv.FeatureGroupFPN(cascade=True),
        lambda: tv.FeatureGroupFPN((8, 16), cascade=True),
        [[x((2, 16, 16, 8)), x((2, 8, 8, 16), 1)]]),
    "IdentityConv": (lambda: jv.IdentityConv(features=8, kernel_size=5),
                     lambda: tv.IdentityConv(C, 8, kernel_size=5),
                     [x((2, 8, 8, C))]),
    "IdentityConv_grouped": (
        lambda: jv.IdentityConv(features=C, kernel_size=3, stride=2,
                                groups=4),
        lambda: tv.IdentityConv(C, C, 3, stride=2, groups=4),
        [x((2, 8, 8, C))]),
    "ReverseFocus": (lambda: jv.ReverseFocus(out_channels=8),
                     lambda: tv.ReverseFocus(C, 8), [x((2, 6, 10, C))]),
    "DyReLU": (lambda: jv.DyReLU(), lambda: tv.DyReLU(C), [x((2, 8, 8, C))]),
    "DeformConv3x3": (
        lambda: jv.DeformConv3x3(out_channels=32),
        lambda: tv.DeformConv3x3(C, 32),
        [x((2, 8, 10, C)), 2.0 * x((2, 8, 10, 18), 1), x((2, 8, 10, 9), 2)]),
    "DeformConv3x3_stride2": (
        lambda: jv.DeformConv3x3(out_channels=32, stride=2),
        lambda: tv.DeformConv3x3(C, 32, stride=2),
        [x((2, 16, 20, C)), 2.0 * x((2, 8, 10, 18), 1),
         x((2, 8, 10, 9), 2)]),
    "DyConv": (lambda: jv.DyConv(channels=C), lambda: tv.DyConv(C),
               [[x((2, 16, 16, C)), x((2, 8, 8, C), 1),
                 x((2, 4, 4, C), 2)]]),
    "DyHead": (lambda: jv.DyHead(channels=C), lambda: tv.DyHead(C),
               [[x((2, 16, 16, C)), x((2, 8, 8, C), 1),
                 x((2, 4, 4, C), 2)]]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_variant_module_matches_flax(name):
    jmake, tmake, inputs = CASES[name]
    assert_pairs(run_pair(jmake(), tmake(), inputs))


@pytest.mark.parametrize("name,shape", [("BatchFormer", (6, 32)),
                                        ("BatchFormerV2", (6, 4, 4, 16))])
def test_batchformer_trains_like_flax(name, shape):
    """Training mode, dropout 0: the batch doubles, its first half the
    input (or its projection) unchanged."""
    if name == "BatchFormer":
        jmod, tmod = jv.BatchFormer(dim=32, dropout=0.0), tv.BatchFormer(
            32, dropout=0.0)
    else:
        from glsdet_tpu.models.variants.batchformer import BatchFormerV2
        jmod = BatchFormerV2(dim=32, dropout=0.0)
        tmod = tv.BatchFormerV2(16, 32, dropout=0.0)
    pairs = run_pair(jmod, tmod, [x(shape)], train=True, init_train=True)
    assert_pairs(pairs)
    (got, _), = pairs
    assert got.shape == (2 * shape[0], 32)
    assert_pairs(run_pair(jmod, tmod, [x(shape)], train=False,
                          init_train=True))


def test_batchformer_dropout_draws_from_the_generator():
    bf = flax_init_(tv.BatchFormer(32), torch.Generator().manual_seed(0))
    f = torch.randn(6, 32, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="generator"):
        bf(f)
    a = bf(f, torch.Generator().manual_seed(5))
    b = bf(f, torch.Generator().manual_seed(5))
    c = bf(f, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:6], f)


def test_functions_match_flax():
    img = x((2, 6, 7, 5))
    rs = np.random.RandomState(3)
    ys = rs.uniform(-2, 8, (2, 4, 9)).astype(np.float32)
    xs = rs.uniform(-2, 9, (2, 4, 9)).astype(np.float32)
    ys[0, 0, :3] = (0.0, 5.0, -1.0)              # exact and edge taps
    xs[0, 0, :3] = (6.0, 0.0, 7.0)
    want = jax.vmap(jv.bilinear_gather)(jnp.asarray(img), jnp.asarray(ys),
                                        jnp.asarray(xs))
    got = tv.bilinear_gather(_nchw(img), torch.from_numpy(ys),
                             torch.from_numpy(xs))
    assert_pairs([(to_np(got.permute(0, 2, 3, 1)), np.asarray(want))])
    t = x((2, 3, 5, 16), 1)
    assert_pairs([(_nhwc(tv.pixel_shuffle_2x(_nchw(t))),
                   np.asarray(jv.pixel_shuffle_2x(jnp.asarray(t))))], 0)
    from glsdet_tpu.models.variants.dyhead import h_sigmoid
    v = 5 * x((64,), 2)
    np.testing.assert_array_equal(to_np(tv.h_sigmoid(torch.from_numpy(v))),
                                  np.asarray(h_sigmoid(jnp.asarray(v))))
    # an odd finer level (9 x 13) is floored by the 2x2/2 pool
    for top, levels in (((8, 12), range(3)), ((9, 13), (1, 2))):
        feats = [x((2, *top, 4)), x((2, 4, 6, 4), 1), x((2, 2, 3, 4), 2)]
        for lvl in levels:
            np.testing.assert_array_equal(
                _nhwc(tv.cross_scale_concat(_nchw(feats), lvl)),
                np.asarray(jv.cross_scale_concat(
                    [jnp.asarray(f) for f in feats], lvl)))


def test_identity_conv_starts_as_the_identity():
    ic = flax_init_(tv.IdentityConv(8, 8, kernel_size=5),
                    torch.Generator().manual_seed(0))
    t = torch.randn(2, 8, 6, 6, generator=torch.Generator().manual_seed(1))
    assert torch.equal(ic(t), t)


def test_se_attention_needs_hw_equal_channels():
    with pytest.raises(ValueError, match="must equal channels"):
        tv.SEAttention(16)(torch.zeros(1, 8, 3, 3))


def test_every_flax_name_is_ported():
    assert set(jv.__all__) <= set(tv.__all__)
