"""Port parity of the YOLOX losses: ``glsdet_tpu_torch.train.yolox_loss``
against the JAX package's ``glsdet_tpu.train.yolox_loss`` on the same
seeded head outputs and padded GTs (``torch_port_util.yolox_fixture``),
CPU.

- ``yolox_loss``: every variant x ``cls_loss_type`` x ``bbox_loss_mode``
  x ``use_l1``; ``yolox_loss_3assign``; ``yolox_loss_fpn_weight`` in each
  mode; ``yolox_loss_decoupled``.  Each output within 1e-5 relative in
  float32 (``num_fg`` equal).
- Gradients with respect to the three head outputs in float64, within
  1e-6 of each leaf's max |grad| (with ``use_l1``, which adds a term to
  every other case's).
- ``_bce_probs`` and the no-sigmoid loss at the clamps (probabilities of
  exactly 0 and 1, and beyond): values and gradients finite and equal to
  JAX's.
"""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import to_np, yolox_fixture

J = importlib.import_module("glsdet_tpu.train.yolox_loss")
P = importlib.import_module("glsdet_tpu_torch.train.yolox_loss")

RTOL, GRAD_TOL = 1e-5, 1e-6
HEADS = ("cls", "reg", "obj")
GTS = ("priors_cxy", "priors_stride", "gt_boxes", "gt_labels", "gt_valid")
LEVELS = (96, 24, 6)              # anchors per level at 64 x 96
FIELDS = ("total", "loss_cls", "loss_bbox", "loss_obj", "loss_l1",
          "num_fg")

PLAIN = list(itertools.product(("mmdet", "cls_sigmoid", "no_sigmoid"),
                               ("bce", "focal"),
                               ("square", "linear", "log", "giou"),
                               (False, True)))
OTHERS = {
    "3assign": ("yolox_loss_3assign", True, {}),
    "fpn_weight_sigmoid": ("yolox_loss_fpn_weight", True, {}),
    "fpn_weight_raw": ("yolox_loss_fpn_weight", True, {"sigmoid": False}),
    "fpn_weight_softmax": ("yolox_loss_fpn_weight", True,
                           {"weight_mode": "softmax"}),
    "fpn_weight_dw": ("yolox_loss_fpn_weight", True,
                      {"neg_cls_terms": True}),
    "decoupled": ("yolox_loss_decoupled", True, {}),
}


def call(mod, name, levels, heads, gts, kw):
    fn = getattr(mod, name)
    if levels:
        return fn(*heads, gts[0], gts[1], LEVELS, *gts[2:], **kw)
    return fn(*heads, *gts, **kw)


def jax_loss(f, name, levels, kw, dtype=np.float32, grad=False):
    """The JAX loss (jitted) on the fixture's arrays; with ``grad`` also
    the gradients of ``total`` w.r.t. the head outputs, in float64."""
    def loss(heads, gts):
        return call(J, name, levels, heads, gts, kw)

    with jax.enable_x64(dtype == np.float64):
        heads = [jnp.asarray(f[k].astype(dtype)) for k in HEADS]
        gts = [jnp.asarray(f[k].astype(dtype) if f[k].dtype == np.float32
                           else f[k].copy()) for k in GTS]
        if not grad:
            return [float(v) for v in jax.jit(loss)(heads, gts)]
        g = jax.jit(jax.grad(lambda h, t: loss(h, t).total))(heads, gts)
        return [np.asarray(x) for x in g]


def port_loss(f, name, levels, kw, dtype=np.float32):
    heads = [torch.from_numpy(f[k].astype(dtype)).requires_grad_()
             for k in HEADS]
    gts = [torch.from_numpy(f[k].astype(dtype) if f[k].dtype == np.float32
                            else f[k].copy()) for k in GTS]
    out = call(P, name, levels, heads, gts, kw)
    return out, heads


def assert_values(out, want, what):
    for field, w in zip(FIELDS, want):
        np.testing.assert_allclose(float(getattr(out, field).detach()), w,
                                   rtol=RTOL, atol=0,
                                   err_msg=f"{what}: {field}")


def assert_grads(heads, want, what):
    for k, h, w in zip(HEADS, heads, want):
        g = to_np(h.grad)
        assert np.isfinite(g).all(), (what, k)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, (what, k, err, scale)


@pytest.fixture(scope="module")
def fixture():
    return yolox_fixture(0)


@pytest.mark.parametrize("variant,cls_type,bbox_mode,use_l1", PLAIN)
def test_yolox_loss_matches_jax(fixture, variant, cls_type, bbox_mode,
                                use_l1):
    kw = dict(variant=variant, cls_loss_type=cls_type,
              bbox_loss_mode=bbox_mode, use_l1=use_l1)
    out, _ = port_loss(fixture, "yolox_loss", False, kw)
    assert float(out.num_fg) > 1
    assert_values(out, jax_loss(fixture, "yolox_loss", False, kw),
                  str(kw))
    if use_l1:
        out64, heads = port_loss(fixture, "yolox_loss", False, kw,
                                 np.float64)
        out64.total.backward()
        assert_grads(heads, jax_loss(fixture, "yolox_loss", False, kw,
                                     np.float64, grad=True), str(kw))


@pytest.mark.parametrize("case", sorted(OTHERS))
def test_loss_families_match_jax(fixture, case):
    name, levels, kw = OTHERS[case]
    out, _ = port_loss(fixture, name, levels, kw)
    assert_values(out, jax_loss(fixture, name, levels, kw), case)
    out64, heads = port_loss(fixture, name, levels, kw, np.float64)
    out64.total.backward()
    assert_grads(heads, jax_loss(fixture, name, levels, kw, np.float64,
                                 grad=True), case)


@pytest.mark.parametrize("mode", ["minmax", "softmax"])
def test_level_weights_match_jax(mode):
    rs = np.random.RandomState(3)
    fg = rs.rand(4, sum(LEVELS)) < 0.1
    fg[1] = False                           # no positive: the tie branch
    fg[2, :96] = fg[2, 96:120].any()        # equal counts on two levels
    got = P._level_weights(torch.from_numpy(fg.copy()), LEVELS, mode)
    want = J._level_weights(jnp.asarray(fg), LEVELS, mode)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_bce_probs_at_the_clamps():
    """Probabilities at 0, 1 and beyond the domain: finite values and
    gradients, equal to the JAX package's."""
    p = np.array([-0.5, 0.0, 1e-30, 1e-8, 0.3, 1 - 1e-7, 1.0, 1.5],
                 np.float32)
    t = np.array([0.0, 1.0, 1.0, 0.0, 0.7, 0.0, 0.0, 1.0], np.float32)
    tp = torch.from_numpy(p.copy()).requires_grad_()
    val = P._bce_probs(tp, torch.from_numpy(t.copy()))
    val.sum().backward()
    jval, jgrad = jax.value_and_grad(
        lambda x: J._bce_probs(x, jnp.asarray(t)).sum())(jnp.asarray(p))
    assert np.isfinite(to_np(val)).all() and np.isfinite(
        to_np(tp.grad)).all()
    np.testing.assert_allclose(float(val.sum().detach()), float(jval),
                               rtol=RTOL)
    np.testing.assert_allclose(to_np(tp.grad), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-6)


def test_no_sigmoid_loss_finite_at_saturated_outputs(fixture):
    """Raw head outputs of exactly 0 and 1 (and a saturated sigmoid in
    the mmdet cost): the loss and its gradients stay finite, as JAX's."""
    f = dict(fixture)
    f["cls"] = f["cls"].copy()
    f["obj"] = f["obj"].copy()
    f["cls"][:, ::4] = 1.0
    f["cls"][:, 1::4] = 0.0
    f["obj"][:, ::5] = 1.0
    f["obj"][:, 2::5] = 0.0
    for variant in ("no_sigmoid", "mmdet"):
        if variant == "mmdet":
            f["cls"][:, ::7] = 30.0             # sigmoid == 1.0 in f32
        kw = dict(variant=variant)
        out, heads = port_loss(f, "yolox_loss", False, kw)
        out.total.backward()
        assert all(np.isfinite(to_np(h.grad)).all() for h in heads)
        assert_values(out, jax_loss(f, "yolox_loss", False, kw), variant)
