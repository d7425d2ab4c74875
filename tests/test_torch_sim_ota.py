"""Port parity of SimOTA: ``glsdet_tpu_torch.assign.sim_ota`` (one call
per batch) against the JAX package's ``sim_ota_assign`` (vmapped over
the images) on the same seeded numpy inputs, float32, CPU.

The fixtures (``torch_port_util.yolox_fixture``) pad the GTs, give one
image no valid GT and another two GTs competing for the same anchors;
one case saturates the joint probability at exactly 1.0, where the
BCE's logs are clamped.  ``fg_mask`` and ``matched_gt`` must be equal,
``matched_iou`` within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.assign.sim_ota import sim_ota_assign as j_sim_ota
from glsdet_tpu.models.yolox_head import decode_boxes as j_decode
from glsdet_tpu_torch.assign.sim_ota import sim_ota_assign
from glsdet_tpu_torch.models.yolox_head import decode_boxes
from torch_port_util import to_np, yolox_fixture

IOU_TOL = 1e-6


def sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x.astype(np.float64)))).astype(np.float32)


def inputs(seed, saturate=False):
    """Decoded boxes (the port's decode, fed to both), probabilities made
    once in numpy, and the GTs."""
    f = yolox_fixture(seed)
    cxy, st = torch.from_numpy(f["priors_cxy"]), torch.from_numpy(
        f["priors_stride"])
    grids = cxy / st[:, None] - 0.5
    dec = to_np(decode_boxes(torch.from_numpy(f["reg"]), grids, st))
    cls_p, obj_p = sigmoid(f["cls"]), sigmoid(f["obj"])
    if saturate:
        # f32 sigmoid(20) == 1.0: whole rows of anchors at p = 1
        cls_p[:, ::3] = 1.0
        obj_p[:, ::3] = 1.0
    return (f["priors_cxy"], f["priors_stride"], dec, cls_p, obj_p,
            f["gt_boxes"], f["gt_labels"], f["gt_valid"])


_jax_assign = {}


def jax_assign(args, **kw):
    key = tuple(sorted(kw.items()))
    if key not in _jax_assign:
        fn = lambda c, s, *per_image: j_sim_ota(c, s, *per_image, **kw)
        _jax_assign[key] = jax.jit(jax.vmap(
            fn, in_axes=(None, None, 0, 0, 0, 0, 0, 0)))
    out = _jax_assign[key](*[jnp.asarray(a.copy()) for a in args])
    return [np.asarray(o) for o in out]


def port_assign(args, **kw):
    return [to_np(o) for o in sim_ota_assign(
        *[torch.from_numpy(a.copy()) for a in args], **kw)]


def assert_same(got, want):
    fg, gt, iou = got
    jfg, jgt, jiou = want
    np.testing.assert_array_equal(fg, jfg)
    np.testing.assert_array_equal(gt, jgt.astype(np.int64))
    np.testing.assert_allclose(iou, jiou, rtol=0, atol=IOU_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("saturate", [False, True])
def test_sim_ota_matches_jax(seed, saturate):
    args = inputs(seed, saturate)
    got, want = port_assign(args), jax_assign(args)
    assert_same(got, want)
    fg, matched = got[0], got[1]
    assert fg[:2].any(), "no positive: the fixture tests nothing"
    assert not fg[2].any() and (matched[2] == -1).all()
    for i in range(2):       # no anchor goes to a padded GT
        assert not np.isin(matched[i], np.nonzero(~args[7][i])[0]).any()


def test_competing_gts_resolved_by_least_cost():
    """Image 1's GT 0 and its shifted copy (GT 1) claim shared anchors;
    each such anchor goes to the GT of least cost, as in JAX."""
    args = inputs(0)
    got = port_assign(args)
    assert_same(got, jax_assign(args))
    alone = list(args)
    alone[7] = args[7].copy()
    alone[7][1, 0] = False                     # GT 1 without GT 0
    took_alone = port_assign(alone)[1][1] == 1
    assert_same(port_assign(alone), jax_assign(alone))
    # anchors GT 1 takes on its own but loses to GT 0 when both compete
    assert (took_alone & (got[1][1] == 0)).any(), "no conflict to resolve"


@pytest.mark.parametrize("weights", [(3.0, 1.0), (1.0, 3.0)])
def test_cost_weights_match_jax(weights):
    """The decoupled loss's two assignments (3 * cls + iou, cls + 3 * iou)
    on raw head outputs (the no-sigmoid ablation's inputs)."""
    f = yolox_fixture(4)
    args = list(inputs(4))
    args[3], args[4] = f["cls"], f["obj"]          # raw, clipped inside
    kw = dict(cls_cost_weight=weights[0], iou_cost_weight=weights[1])
    assert_same(port_assign(args, **kw), jax_assign(args, **kw))


def test_no_valid_gt_anywhere():
    args = list(inputs(5))
    args[7] = np.zeros_like(args[7])
    fg, gt, iou = port_assign(args)
    assert not fg.any() and (gt == -1).all() and (iou == 0).all()
    assert_same((fg, gt, iou), jax_assign(args))


@pytest.mark.parametrize("outside", ["negative", "num_classes"])
def test_label_outside_the_classes_matches_jax(outside):
    """A valid GT whose label lies outside [0, C): JAX's one-hot row is
    all zeros, so its class cost is the sum of log(1 - p) alone; the
    port's gather takes its zero column."""
    args = list(inputs(0))
    label = -1 if outside == "negative" else args[3].shape[-1]
    args[6] = args[6].copy()
    args[6][:, ::2] = label
    got = port_assign(args)
    assert got[0][:2].any()
    assert_same(got, jax_assign(args))
