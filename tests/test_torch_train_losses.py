"""Port parity of MP-Det's targets and losses: the JAX package's functions
vs the port's on the same seeded numpy inputs (float32, CPU).

Tolerances: loss values within 1e-5 relative; gradients through each
loss within 1e-4 of the leaf's max |grad|; ATSS assignments (padded GTs
included) equal; the dictionary update (with the JAX package's noise)
gives equal embeddings and pointers; ``update_ot`` on well-separated
clusters, where every seeding finds the same clusters, gives equal
marginals.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glsdet_tpu.losses as jlosses
import glsdet_tpu_torch.losses as losses
from glsdet_tpu.assign.atss import atss_assign as j_atss
from glsdet_tpu.models.mp_head import proxy_class_matrix
from glsdet_tpu.ops.priors import grid_anchors
from glsdet_tpu_torch.assign.atss import atss_assign
from torch_port_util import to_np

# the train packages export functions named like these modules
jboiw = importlib.import_module("glsdet_tpu.train.boiw")
jgfl = importlib.import_module("glsdet_tpu.train.gfl_loss")
jmp = importlib.import_module("glsdet_tpu.train.mp_loss")
boiw = importlib.import_module("glsdet_tpu_torch.train.boiw")
gfl_loss = importlib.import_module("glsdet_tpu_torch.train.gfl_loss")
mp_loss = importlib.import_module("glsdet_tpu_torch.train.mp_loss")

T = torch.from_numpy
NC, HW = 10, (64, 96)
PROXIES = (2, 3, 2, 5, 4, 8, 8, 4, 3, 3)
STRIDES = (8, 16, 32, 64, 128)
RTOL, GRAD_TOL = 1e-5, 1e-4


def gts(rs, b=2, g=6):
    """Padded GTs: integer-cornered boxes (so that centre distances tie
    exactly, as on real annotations) and float ones, the last two of
    each image padding."""
    x1 = rs.uniform(0, HW[1] - 30, (b, g))
    y1 = rs.uniform(0, HW[0] - 30, (b, g))
    x1[:, :2], y1[:, :2] = np.round(x1[:, :2]), np.round(y1[:, :2])
    w = rs.uniform(4, 30, (b, g))
    h = rs.uniform(4, 30, (b, g))
    w[:, :2], h[:, :2] = 16.0, 8.0
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    labels = rs.randint(0, NC, (b, g)).astype(np.int32)
    valid = np.ones((b, g), bool)
    valid[:, -2:] = False
    return boxes, labels, valid


def jax_targets(boxes, labels, valid):
    anchors, counts = grid_anchors(HW, STRIDES, octave_base_scale=8.0)
    t = jgfl.gfl_targets(jnp.asarray(anchors), counts, jnp.asarray(boxes),
                         jnp.asarray(labels), jnp.asarray(valid), NC)
    return anchors, counts, t


def port_targets(anchors, counts, boxes, labels, valid):
    return gfl_loss.gfl_targets(T(anchors), counts, T(boxes.copy()),
                                T(labels.copy()), T(valid.copy()), NC)


def value_and_grads(jfn, tfn, arrays):
    """``jfn`` / ``tfn`` of the same float arrays, each returning a tuple
    of scalar losses: every value, and every loss's gradient with
    respect to every array (the JAX side compiled once)."""
    ja = [jnp.asarray(a) for a in arrays]
    wvals = jax.jit(jfn)(*ja)
    vjp = jax.jit(lambda ct, *a: jax.vjp(jfn, *a)[1](ct))
    ts = [T(a.copy()).requires_grad_() for a in arrays]
    gvals = tfn(*ts)
    assert len(gvals) == len(wvals)
    for i, (gv, wv) in enumerate(zip(gvals, wvals)):
        np.testing.assert_allclose(float(gv), float(wv), rtol=RTOL,
                                   err_msg=f"loss {i}")
        ct = tuple(jnp.float32(j == i) for j in range(len(wvals)))
        grads = torch.autograd.grad(gv, ts, retain_graph=True,
                                    allow_unused=True)
        for g, t, w in zip(grads, ts, vjp(ct, *ja)):
            w = np.asarray(w)
            g = torch.zeros_like(t) if g is None else g
            np.testing.assert_allclose(
                to_np(g), w, rtol=0,
                atol=GRAD_TOL * max(float(np.abs(w).max()), 1e-12),
                err_msg=f"gradient of loss {i}")


LOSSES = ["bce_with_logits", "quality_focal_loss", "distribution_focal_loss",
          "giou_loss", "iou_loss", "l1_loss", "sigmoid_focal_loss",
          "softmax_cross_entropy"]


@pytest.mark.parametrize("name", LOSSES)
def test_losses(name):
    rs = np.random.RandomState(len(name))
    n, c = 12, 5
    logits = (2 * rs.randn(n, c)).astype(np.float32)
    labels = rs.randint(0, c + 1, n)
    w = rs.rand(n).astype(np.float32)
    xy = rs.uniform(0, 50, (n, 2))
    b1 = np.concatenate([xy, xy + rs.uniform(1, 20, (n, 2))], -1)
    b2 = np.concatenate([xy + 3, xy + rs.uniform(1, 20, (n, 2))], -1)
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    if name in ("giou_loss", "l1_loss") or name == "iou_loss":
        arrays = [b1, b2]
        call = lambda mod, a, b: getattr(mod, name)(a, b)
    elif name == "bce_with_logits":
        arrays = [logits, rs.rand(n, c).astype(np.float32)]
        call = lambda mod, a, b: mod.bce_with_logits(a, b)
    elif name == "quality_focal_loss":
        arrays = [logits, rs.rand(n).astype(np.float32)]
        call = lambda mod, a, q: mod.quality_focal_loss(
            a, (jnp.asarray if mod is jlosses else T)(labels.copy()), q, c)
    elif name == "distribution_focal_loss":
        arrays = [rs.randn(n, 17).astype(np.float32),
                  rs.uniform(0, 15.9, n).astype(np.float32)]
        call = lambda mod, a, t: mod.distribution_focal_loss(a, t)
    elif name == "sigmoid_focal_loss":
        arrays = [logits]
        call = lambda mod, a: mod.sigmoid_focal_loss(
            a, (jnp.asarray if mod is jlosses else T)(labels.copy()), c)
    else:
        arrays = [logits]
        call = lambda mod, a: mod.softmax_cross_entropy(
            a, (jnp.asarray if mod is jlosses else T)(labels.copy() % c))
    if name == "iou_loss":
        modes = ("square", "log", "linear")
        value_and_grads(
            lambda a, b: tuple(jnp.sum(jlosses.iou_loss(a, b, m) * w)
                               for m in modes),
            lambda a, b: tuple((losses.iou_loss(a, b, m) * T(w)).sum()
                               for m in modes), arrays)
        return
    value_and_grads(lambda *a: (jnp.sum(call(jlosses, *a).T * w),),
                    lambda *a: ((call(losses, *a).T * T(w)).sum(),), arrays)


@pytest.mark.parametrize("seed", [0, 1])
def test_atss_assign(seed):
    boxes, labels, valid = gts(np.random.RandomState(seed))
    anchors, counts = grid_anchors(HW, STRIDES, octave_base_scale=8.0)
    got = atss_assign(T(anchors), counts, T(boxes), T(labels), T(valid), NC)
    assign = jax.jit(lambda b, l, v: j_atss(jnp.asarray(anchors), counts,
                                            b, l, v, NC))
    for i in range(boxes.shape[0]):
        want = assign(boxes[i], labels[i], valid[i])
        np.testing.assert_array_equal(to_np(got.assigned_gt[i]),
                                      np.asarray(want.assigned_gt))
        np.testing.assert_array_equal(to_np(got.labels[i]),
                                      np.asarray(want.labels))
        np.testing.assert_allclose(to_np(got.max_iou[i]),
                                   np.asarray(want.max_iou), atol=1e-6)
        assert not np.isin(np.asarray(want.assigned_gt), [4, 5]).any()
    assert (to_np(got.assigned_gt) >= 0).sum() > 0


def head_outputs(rs, a, c=16, b=2):
    feats = rs.randn(b, a, c).astype(np.float32)
    bbox = rs.randn(b, a, 4 * 17).astype(np.float32)
    return feats, bbox


def test_gfl_targets_and_loss():
    rs = np.random.RandomState(2)
    boxes, labels, valid = gts(rs)
    valid[1] = False                            # an image without GTs
    anchors, counts, jt = jax_targets(boxes, labels, valid)
    tt = port_targets(anchors, counts, boxes, labels, valid)
    for got, want in zip(tt, jt):
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-6)
    a = anchors.shape[0]
    centers = ((anchors[:, :2] + anchors[:, 2:]) / 2).astype(np.float32)
    strides = np.concatenate([np.full(n, s, np.float32)
                              for n, s in zip(counts, STRIDES)])
    scores, bbox = rs.randn(2, a, NC).astype(np.float32), \
        rs.randn(2, a, 68).astype(np.float32)
    for floor in (1.0, 1e-6):
        value_and_grads(
            lambda s, p: jgfl.gfl_loss(s, p, jt, centers, strides, NC,
                                       avg_factor_floor=floor)[:4],
            lambda s, p: gfl_loss.gfl_loss(s, p, tt, T(centers), T(strides),
                                           NC, avg_factor_floor=floor)[:4],
            [scores, bbox])


def test_contrastive_and_ot_losses():
    rs = np.random.RandomState(3)
    n, c = 300, 16
    feats = rs.randn(n, c).astype(np.float32)
    labels = rs.randint(0, NC + 1, n)
    labels[labels == 3] = NC                    # a class without positives
    emb = rs.randn(NC + 1, 8, c).astype(np.float32)
    weights = rs.rand(n).astype(np.float32)
    proxies = rs.randn(sum(PROXIES), c).astype(np.float32)
    prob = np.concatenate([rs.dirichlet(np.ones(k)) for k in PROXIES]
                          ).astype(np.float32)
    value_and_grads(
        lambda f, e: (jmp.contrastive_loss(f, jnp.asarray(labels), e, 37.0,
                                           jnp.asarray(weights)),),
        lambda f, e: (mp_loss.contrastive_loss(f, T(labels), e,
                                               torch.tensor(37.0),
                                               T(weights)),),
        [feats, emb])
    value_and_grads(
        lambda f, p: (jmp.ot_proxy_loss(f, jnp.asarray(labels), p,
                                        jnp.asarray(prob), PROXIES,
                                        max_pos_per_class=20),),
        lambda f, p: (mp_loss.ot_proxy_loss(f, T(labels), p, T(prob),
                                            PROXIES, max_pos_per_class=20),),
        [feats, proxies])


def j_state(emb, ptr, prob, beta):
    return jboiw.BoIWState(jnp.asarray(emb), jnp.asarray(ptr, jnp.int32),
                           jnp.asarray(prob), jnp.asarray(beta, jnp.float32))


def t_state(emb, ptr, prob, beta):
    return boiw.BoIWState(T(emb.copy()), T(np.asarray(ptr, np.int64)),
                          T(prob.copy()), torch.tensor(beta))


def test_mp_loss():
    rs = np.random.RandomState(4)
    boxes, labels, valid = gts(rs)
    anchors, counts, jt = jax_targets(boxes, labels, valid)
    tt = port_targets(anchors, counts, boxes, labels, valid)
    a = anchors.shape[0]
    centers = ((anchors[:, :2] + anchors[:, 2:]) / 2).astype(np.float32)
    strides = np.concatenate([np.full(n, s, np.float32)
                              for n, s in zip(counts, STRIDES)])
    feats, bbox = head_outputs(rs, a)
    proxies = (0.3 * rs.randn(sum(PROXIES), 16)).astype(np.float32)
    emb = rs.randn(NC + 1, 8, 16).astype(np.float32)
    ptr = rs.randint(0, 8, NC + 1)
    prob = np.concatenate([np.full(k, 1.0 / k) for k in PROXIES]
                          ).astype(np.float32)
    memb = proxy_class_matrix(PROXIES)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.uniform(key, (NC + 1, 2 * a)))
    # total, loss_cls, loss_bbox, loss_dfl, loss_emb, loss_op
    value_and_grads(
        lambda f, p, x: jmp.mp_loss(
            f, p, x, jnp.asarray(memb), j_state(emb, ptr, prob, 1.0),
            key, jt, centers, strides, NC, PROXIES)[:6],
        lambda f, p, x: mp_loss.mp_loss(
            f, p, x, T(memb), t_state(emb, ptr, prob, 1.0), None, tt,
            T(centers), T(strides), NC, PROXIES, noise=T(noise))[:6],
        [feats, bbox, proxies])
    want = jax.jit(lambda f, p, x: jmp.mp_loss(
        f, p, x, jnp.asarray(memb), j_state(emb, ptr, prob, 0.0), key, jt,
        centers, strides, NC, PROXIES))(feats, bbox, proxies)
    got = mp_loss.mp_loss(T(feats), T(bbox), T(proxies), T(memb),
                          t_state(emb, ptr, prob, 0.0), None, tt,
                          T(centers), T(strides), NC, PROXIES,
                          noise=T(noise))
    assert float(got.loss_emb) == float(want.loss_emb) == 0.0
    np.testing.assert_allclose(to_np(got.boiw.embedding),
                               np.asarray(want.boiw.embedding), atol=1e-6)
    np.testing.assert_array_equal(to_np(got.boiw.ptr),
                                  np.asarray(want.boiw.ptr))


def test_update_dictionary_with_the_jax_noise():
    rs = np.random.RandomState(5)
    n, c, words = 400, 8, 16
    feats = rs.randn(n, c).astype(np.float32)
    labels = rs.randint(0, NC + 1, n)
    labels[labels == 2] = 0                     # class 2 empty
    labels[:40] = 5                             # class 5 past max_step
    emb = rs.randn(NC + 1, words, c).astype(np.float32)
    ptr = rs.randint(0, words, NC + 1)
    prob = np.ones(sum(PROXIES), np.float32)
    key = jax.random.PRNGKey(11)
    want = jboiw.update_dictionary(j_state(emb, ptr, prob, 0.0), key,
                                   jnp.asarray(feats), jnp.asarray(labels))
    noise = np.array(jax.random.uniform(key, (NC + 1, n)))
    got = boiw.update_dictionary(t_state(emb, ptr, prob, 0.0), None,
                                 T(feats), T(labels), noise=T(noise))
    np.testing.assert_array_equal(to_np(got.embedding),
                                  np.asarray(want.embedding))
    np.testing.assert_array_equal(to_np(got.ptr), np.asarray(want.ptr))


def test_update_ot_on_separated_clusters():
    """Each class's words are k tight bunches around orthogonal
    directions: any seeding finds them, so both packages give the same
    sorted cluster-size marginals."""
    rs = np.random.RandomState(6)
    words, c = 40, 16
    emb = np.zeros((NC + 1, words, c), np.float32)
    for cls, k in enumerate(PROXIES):
        sizes = np.full(k, words // (k + 1))
        sizes[0] += words - sizes.sum()
        dirs = np.eye(c, dtype=np.float32)[rs.permutation(c)[:k]]
        rows = np.repeat(dirs, sizes, axis=0)
        emb[cls] = rows + 0.01 * rs.randn(words, c)
    prob = np.ones(sum(PROXIES), np.float32)
    want = jax.jit(lambda st, key: jboiw.update_ot(st, key, PROXIES))(
        j_state(emb, np.zeros(NC + 1), prob, 1.0), jax.random.PRNGKey(0))
    got = boiw.update_ot(t_state(emb, np.zeros(NC + 1), prob, 1.0),
                         torch.Generator().manual_seed(0), PROXIES)
    np.testing.assert_allclose(to_np(got.proxies_prob),
                               np.asarray(want.proxies_prob), atol=1e-7)
    for k, block in zip(PROXIES, np.split(to_np(got.proxies_prob),
                                          np.cumsum(PROXIES)[:-1])):
        np.testing.assert_allclose(block.sum(), 1.0, rtol=1e-6)
