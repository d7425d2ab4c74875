"""Port parity: global-local fusion (``eval/fusion.py``) and soft-NMS
(``ops/nms.py: soft_nms``) against the JAX package's, on the CPU.

Detection sets are made from a seed with numpy: clusters of jittered
boxes, ten classes, same-class near-duplicates within a set and across
the two (so that NMS suppresses), some invalid rows, scores with ties
(repeated values, across both sets and within one).  The hard
fusion only selects rows, so boxes, labels and valid are equal and
scores equal; soft-NMS multiplies scores by exponentials, which the two
frameworks may round differently in the last bit: scores within 1e-6
(relative too: soft-NMS also decays the invalid rows' -1e9 scores, and
one whose decay falls below 1/2 ranks as valid with a score near -5e8,
in both packages), the selection equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.eval.fusion import fuse_detections as jfuse
from glsdet_tpu.eval.fusion import fuse_detections_batch as jfuse_batch
from glsdet_tpu.ops.nms import soft_nms as jsoft
from glsdet_tpu_torch.eval.fusion import (fuse_detections,
                                          fuse_detections_batch)
from glsdet_tpu_torch.ops.nms import soft_nms


def _dets(rs, k, invalid=0.2, ties=True, all_invalid=False, like=None):
    """k rows; every fourth a jittered copy (same label) of the row before
    it, and with ``like`` (the other set) every fifth a jittered copy of
    one of its rows: near-duplicates within and across the sets, which
    NMS suppresses."""
    centres = rs.uniform(0, 300, (max(k // 5, 1), 2))
    c = centres[rs.randint(0, len(centres), k)] + rs.normal(0, 4, (k, 2))
    wh = rs.uniform(8, 40, (k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    labels = rs.randint(0, 10, k).astype(np.int64)
    boxes[3::4] = boxes[2::4][:len(boxes[3::4])] + rs.normal(0, 1, (1, 4))
    labels[3::4] = labels[2::4][:len(labels[3::4])]
    if like is not None:
        src = rs.randint(0, len(like["labels"]), len(boxes[::5]))
        boxes[::5] = like["boxes"][src] + rs.normal(0, 1, (len(src), 4))
        labels[::5] = like["labels"][src]
    scores = rs.uniform(0.01, 1.0, k).astype(np.float32)
    if ties:
        scores[1::3] = scores[0]              # one value on many rows
        scores[2::7] = np.float32(0.5)
    valid = rs.rand(k) > invalid
    if all_invalid:
        valid[:] = False
    return {"boxes": boxes.astype(np.float32), "scores": scores,
            "labels": labels, "valid": valid}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _j(d):
    out = {k: jnp.asarray(np.array(v)) for k, v in d.items()}
    out["labels"] = out["labels"].astype(jnp.int32)
    return out


def _equal(got, want, score_atol=0.0):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_array_equal(got["boxes"][v], want["boxes"][v])
    np.testing.assert_allclose(got["scores"], want["scores"],
                               rtol=score_atol, atol=score_atol)


CASES = {
    "plain": dict(),
    "no_ties": dict(ties=False),
    "mostly_invalid": dict(invalid=0.8),
    "a_all_invalid": dict(all_invalid=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("iou_thr", [0.5, 0.65])
def test_hard_fusion_equal(case, iou_thr):
    rs = np.random.RandomState(len(case))
    a = _dets(rs, 60, **CASES[case])
    b = _dets(rs, 80, like=a)
    got = fuse_detections(_t(a), _t(b), iou_thr, 140)
    want = jfuse(_j(a), _j(b), iou_thr, 140)
    _equal(got, want)
    # every row fits the output, so NMS suppressed some
    assert 0 < int(got["valid"].sum()) < int(a["valid"].sum()
                                             + b["valid"].sum())


def test_hard_fusion_both_sets_invalid():
    rs = np.random.RandomState(3)
    a = _dets(rs, 20, all_invalid=True)
    b = _dets(rs, 30, all_invalid=True)
    got = fuse_detections(_t(a), _t(b), 0.65, 40)
    _equal(got, jfuse(_j(a), _j(b), 0.65, 40))
    assert not got["valid"].any() and not got["scores"].any()


def test_hard_fusion_batch_equal_to_the_vmapped_one():
    rs = np.random.RandomState(4)
    a = [_dets(rs, 50) for _ in range(3)]
    b = [_dets(rs, 70, invalid=0.5, like=d) for d in a]
    stack = lambda ds: {k: np.stack([d[k] for d in ds])  # noqa: E731
                        for k in ds[0]}
    got = fuse_detections_batch(_t(stack(a)), _t(stack(b)), 0.65, 90)
    want = jfuse_batch(_j(stack(a)), _j(stack(b)), 0.65, 90)
    _equal(got, want)


@pytest.mark.parametrize("case", ["plain", "mostly_invalid"])
@pytest.mark.parametrize("sigma", [0.5, 0.3])
def test_soft_fusion_equal(case, sigma):
    rs = np.random.RandomState(10 + len(case))
    a = _dets(rs, 40, **CASES[case])
    b = _dets(rs, 50, like=a)
    got = fuse_detections(_t(a), _t(b), 0.65, 60, use_soft=True, sigma=sigma)
    want = jfuse(_j(a), _j(b), 0.65, 60, True, sigma)
    _equal(got, want, score_atol=1e-6)


@pytest.mark.parametrize("method", ["gaussian", "linear"])
@pytest.mark.parametrize("ties", [True, False])
def test_soft_nms_equal(method, ties):
    rs = np.random.RandomState(20)
    d = _dets(rs, 64, ties=ties)
    scores = np.where(d["valid"], d["scores"], np.float32(-1e9))
    got = soft_nms(torch.from_numpy(d["boxes"].copy()),
                   torch.from_numpy(scores.copy()), iou_threshold=0.3,
                   sigma=0.5, score_threshold=0.001, method=method)
    want = jsoft(jnp.asarray(d["boxes"]), jnp.asarray(scores), 0.3, 0.5,
                 0.001, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # overlapping boxes were decayed
    assert (got.numpy()[d["valid"]] < scores[d["valid"]]).any()


def test_soft_nms_all_invalid_and_identical_boxes():
    boxes = np.tile(np.array([[10, 10, 50, 50]], np.float32), (6, 1))
    for scores in (np.full(6, -1e9, np.float32),
                   np.array([0.9, 0.9, 0.5, 0.9, 0.2, 0.0005], np.float32)):
        got = soft_nms(torch.from_numpy(boxes.copy()),
                       torch.from_numpy(scores.copy()))
        want = jsoft(jnp.asarray(boxes), jnp.asarray(scores))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_soft_nms_rejects_an_unknown_method():
    with pytest.raises(ValueError, match="method"):
        soft_nms(torch.zeros(2, 4), torch.ones(2), method="hard")
