"""Port parity of the training path's ops, schedules and optimizers: the
JAX package's functions vs the port's on the same seeded numpy inputs.

Tolerances, per check: top-k and first-k indices equal (ties included);
boxes, bbox2distance and the anchors within 1e-6; both Sinkhorn forms
and the differentiable form's gradient (against ``jax.grad``) within
1e-5 relative; k-means from given centres: assignments equal; schedules
within two float32 ulps (2.4e-7 relative); optimizer updates on equal gradients within 1e-6
of each leaf's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glsdet_tpu.ops import boxes as jboxes
from glsdet_tpu.ops import kmeans as jkmeans
from glsdet_tpu.ops import priors as jpriors
from glsdet_tpu.ops.integral import bbox2distance as j_b2d
from glsdet_tpu.ops.sinkhorn import sinkhorn as j_sinkhorn
from glsdet_tpu.ops.topk import first_k_true as j_first_k
from glsdet_tpu.ops.topk import topk_small_k as j_topk
from glsdet_tpu.train import schedules as jsched
from glsdet_tpu.train.loop import build_optimizer as j_build_optimizer
from glsdet_tpu_torch.config import apply_overrides, get_config
from glsdet_tpu_torch.ops import boxes, kmeans, priors
from glsdet_tpu_torch.ops.integral import bbox2distance
from glsdet_tpu_torch.ops.sinkhorn import sinkhorn
from glsdet_tpu_torch.ops.topk import first_k_true, topk_small_k
from glsdet_tpu_torch.train import schedules
from glsdet_tpu_torch.train.loop import build_optimizer
from torch_port_util import to_np

T = torch.from_numpy


def rand_boxes(rs, shape, extent=100.0):
    xy = rs.uniform(0, extent, shape + (2,))
    wh = rs.uniform(0, extent / 3, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("k", [1, 9, 10, 37])
def test_topk_small_k_tie_order(k):
    # few distinct values: most of the k are ties
    x = np.random.RandomState(k).randint(0, 4, (3, 7, 37)).astype(np.float32)
    wv, wi = j_topk(jnp.asarray(x), k)
    gv, gi = topk_small_k(T(x.copy()), k)
    np.testing.assert_array_equal(to_np(gi), np.asarray(wi))
    np.testing.assert_array_equal(to_np(gv), np.asarray(wv))
    np.testing.assert_array_equal(to_np(gi),
                                  np.asarray(jax.lax.top_k(x, k)[1]))


@pytest.mark.parametrize("k", [1, 5, 64])
def test_first_k_true(k):
    m = np.random.RandomState(k).rand(4, 50) < 0.2
    m[0] = False
    m[1] = True
    wi, wv = j_first_k(jnp.asarray(m), k)
    gi, gv = first_k_true(T(m.copy()), k)
    np.testing.assert_array_equal(to_np(gv), np.asarray(wv))
    v = np.asarray(wv)
    np.testing.assert_array_equal(to_np(gi)[v], np.asarray(wi)[v])


BOX_FNS = ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_xywh_to_xyxy",
           "box_xyxy_to_xywh"]
PAIR_FNS = ["pairwise_iou", "pairwise_iof", "iou", "iof", "giou"]


@pytest.mark.parametrize("name", BOX_FNS + PAIR_FNS + ["bbox_overlaps",
                                                       "clip_boxes",
                                                       "scale_boxes"])
def test_boxes(name):
    rs = np.random.RandomState(len(name))
    a, b = rand_boxes(rs, (6,)), rand_boxes(rs, (6,))
    a[0] = b[0] = 0.0                           # a padding box
    if name in BOX_FNS:
        want, got = getattr(jboxes, name)(a), getattr(boxes, name)(T(a))
    elif name in PAIR_FNS:
        want = getattr(jboxes, name)(a, b)
        got = getattr(boxes, name)(T(a), T(b))
    elif name == "bbox_overlaps":
        for mode in ("iou", "iof"):
            for aligned in (False, True):
                np.testing.assert_allclose(
                    to_np(boxes.bbox_overlaps(T(a), T(b), mode, aligned, 1.0)),
                    np.asarray(jboxes.bbox_overlaps(a, b, mode, aligned,
                                                    1.0)), atol=1e-6)
        return
    elif name == "clip_boxes":
        want, got = jboxes.clip_boxes(a, 60, 70), boxes.clip_boxes(T(a), 60, 70)
    else:
        want = jboxes.scale_boxes_about_center(a, 1.5, (70, 60))
        got = boxes.scale_boxes_about_center(T(a), 1.5, (70, 60))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-6)


def test_bbox2distance_and_anchors():
    hw, strides = (96, 128), (8, 16, 32, 64, 128)
    wa, wc = jpriors.grid_anchors(hw, strides, octave_base_scale=8.0)
    ga, gc = priors.grid_anchors(hw, strides, octave_base_scale=8.0)
    assert gc == wc
    np.testing.assert_allclose(ga, wa, atol=1e-6)
    np.testing.assert_allclose(priors.anchor_centers(ga),
                               jpriors.anchor_centers(wa), atol=1e-6)
    pts = priors.anchor_centers(ga)[:6] / 8.0
    bx = rand_boxes(np.random.RandomState(0), (6,), 20.0)
    for reg_max in (None, 16):
        np.testing.assert_allclose(
            to_np(bbox2distance(T(pts), T(bx), reg_max)),
            np.asarray(j_b2d(pts, bx, reg_max)), atol=1e-6)


def sinkhorn_inputs(seed):
    rs = np.random.RandomState(seed)
    cost = rs.rand(3, 20, 6).astype(np.float32)
    marg = rs.rand(3, 6).astype(np.float32)
    marg[:, -2:] = 0.0                          # padded columns
    marg /= marg.sum(-1, keepdims=True)
    mask = rs.rand(3, 20) < 0.7
    mask[2] = False                             # a class with no rows
    return cost, marg, mask


@pytest.mark.parametrize("differentiable", [False, True])
def test_sinkhorn_matches_jax(differentiable):
    cost, marg, mask = sinkhorn_inputs(1)
    want = jax.vmap(lambda c, m, r: j_sinkhorn(
        c, m, reg=0.1, row_mask=r, differentiable=differentiable))(
            cost, marg, mask)
    got = sinkhorn(T(cost), T(marg), reg=0.1, row_mask=T(mask),
                   differentiable=differentiable)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_sinkhorn_gradient_goes_through_the_iterations():
    cost, marg, mask = sinkhorn_inputs(2)

    def jloss(c):
        p = jax.vmap(lambda c, m, r: j_sinkhorn(
            c, m, row_mask=r, differentiable=True))(c, marg, mask)
        return jnp.sum(p * c)

    want = jax.grad(jloss)(cost)
    c = T(cost.copy()).requires_grad_()
    (sinkhorn(c, T(marg), row_mask=T(mask), differentiable=True)
     * c).sum().backward()
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(to_np(c.grad), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * scale)
    # not the envelope gradient (the plan alone)
    plan = to_np(sinkhorn(T(cost), T(marg), row_mask=T(mask),
                          differentiable=True))
    assert np.abs(plan - np.asarray(want)).max() > 1e-3 * scale


def test_cosine_kmeans_from_given_centres():
    rs = np.random.RandomState(3)
    data = rs.randn(60, 8).astype(np.float32)
    init = data[[0, 7, 21, 40]]
    _, wa, wi = jkmeans.cosine_kmeans(None, jnp.asarray(data), 4,
                                      init_centers=jnp.asarray(init))
    _, ga, gi = kmeans.cosine_kmeans(None, T(data), 4,
                                     init_centers=T(init.copy()))
    np.testing.assert_array_equal(to_np(ga), np.asarray(wa))
    np.testing.assert_allclose(float(gi), float(wi), rtol=1e-5)
    np.testing.assert_allclose(
        to_np(kmeans.cluster_size_probs(ga, 4, 60)),
        np.asarray(jkmeans.cluster_size_probs(wa, 4, 60)), atol=1e-7)


SCHEDULES = [
    ("schedule_1x", (0.01, 50)),
    ("yolox_warm_cos", (0.01, 30, 700, 100)),
    ("epoch_step_decay", (1e-3, 40)),
]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedules(name, args):
    want, got = getattr(jsched, name)(*args), getattr(schedules, name)(*args)
    for step in (0, 1, 17, 29, 30, 31, 399, 400, 401, 550, 599, 600, 650,
                 699, 700, 5000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=2.4e-7)
    for step in (0, 1, 100, 2000, 10 ** 5):
        np.testing.assert_allclose(schedules.ema_momentum(step),
                                   float(jsched.ema_momentum(step)),
                                   rtol=2.4e-7)


OPTIMIZER_CFGS = {
    "mp_sgd": {"train.optimizer": "mp_sgd", "train.weight_decay": 1e-4,
               "train.grad_clip": 1.0, "train.base_lr": 0.5},
    "yolox_sgd": {"train.optimizer": "yolox_sgd", "train.base_lr": 0.5,
                  "train.warmup_epochs": 1},
    "adam_step": {"train.optimizer": "adam_step", "train.base_lr": 0.1},
}


@pytest.mark.parametrize("name", list(OPTIMIZER_CFGS))
def test_build_optimizer_matches_optax(name):
    """Three updates on equal gradients (the clip binding on the first
    two for mp_sgd): clip -> decay -> momentum, the decay mask, Nesterov,
    Adam, and the learning rate read at the count before each update."""
    from glsdet_tpu.config import apply_overrides as j_overrides
    from glsdet_tpu.config import get_config as j_get_config

    opts = dict(OPTIMIZER_CFGS[name], **{"train.epochs": 12})
    rs = np.random.RandomState(4)
    params = {"conv": rs.randn(4, 3, 3, 3).astype(np.float32),
              "bias": rs.randn(4).astype(np.float32),
              "scale": rs.randn(1).astype(np.float32)}
    tx = j_build_optimizer(j_overrides(j_get_config("mp_det_res50"), opts), 2)
    model = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(T(v.copy())) for k, v in params.items()})
    opt = build_optimizer(apply_overrides(get_config("mp_det_res50"), opts),
                          2, model)
    jp, js = dict(params), tx.init(params)
    for i, gscale in enumerate((3.0, 2.0, 0.01)):
        grads = {k: gscale * rs.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        upd, js = tx.update(grads, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in model.items():
            p.grad = T(grads[k].copy())
        opt.step()
        for k, p in model.items():
            want = np.asarray(jp[k])
            np.testing.assert_allclose(
                to_np(p), want, rtol=0,
                atol=1e-6 * float(np.abs(want).max()), err_msg=f"{k} {i}")
    assert opt.count == 3


def test_device_color_plain_batches():
    """normalize_images as the JAX package's; a plain batch's images pass
    through, and the augmentation keys of the data pipeline render as the
    JAX package's apply_batch_color renders them (eagerly)."""
    import jax

    from glsdet_tpu.data.device_color import apply_batch_color as j_color
    from glsdet_tpu.data.device_color import normalize_images as j_norm
    from glsdet_tpu_torch.data.device_color import (apply_batch_color,
                                                    normalize_images)

    img = np.random.RandomState(0).randint(0, 256, (2, 5, 7, 3), np.uint8)
    batch = {"images": T(img.copy())}
    got = normalize_images(apply_batch_color(batch))
    np.testing.assert_allclose(to_np(got), np.asarray(j_norm(img)),
                               rtol=1e-6, atol=1e-6)
    assert apply_batch_color(batch) is batch["images"]
    assert normalize_images(batch["images"], False) is batch["images"]
    keys = {"mix_images": img[::-1].copy(),
            "mix_weight": np.array([1.0, 0.5], np.float32),
            "hsv_deltas": np.array([[2, -9, 4], [-3, 12, 0]], np.float32)}
    for key in ("mix_images", "hsv_deltas"):
        extra = ({k: keys[k] for k in ("mix_images", "mix_weight")}
                 if key == "mix_images" else {key: keys[key]})
        with jax.disable_jit():
            want = j_color({"images": img, **extra})
        got = apply_batch_color({"images": T(img.copy()),
                                 **{k: T(v.copy()) for k, v in extra.items()}})
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
    with pytest.raises(ValueError, match="out_hw"):
        apply_batch_color(dict(batch, geom_sources=batch["images"]))
