"""``glsdet_tpu_torch.tools.build_ufp_dataset`` against the JAX package's
``tools/build_ufp_dataset.py``, both run here on the CPU on the same PNG
frames (ground truth, and an ignore region in frame 0).

(a) Both tools' ``yolox_postprocess`` return the same fixed detections
(frame 2 gets none, so it writes no mosaic); the JAX forward is left
unjitted so that each frame gets its own, and its model, whose output
the stand-in ignores, is a stub.  Then ``ufp_train.json`` must
be equal and every mosaic JPEG byte-equal.  The inputs hold a detection
that overhangs the frame and frame 0's detections pack to a region whose
corner lies within 1e-3 of an integer (56.99907, which ``int()`` floors
to 56), both checked on the packer's own output.  The packer clips its
regions to the frame, so the paint loop's own clips are reached only
with regions made by hand: the second case replaces both tools' packer
by the same hand-made regions: one overhanging the frame's right and
bottom edges (its crop clipped, then stretched), one left of it
(``int(-3.4)`` is -3), one wholly outside (an empty crop, skipped), and
one with fields 68.00016975 and 11.9996 whose paste overhangs the
mosaic's floored edge.

(b) Both tools read one JAX ``TrainState`` (orbax) of a seeded
YOLOX-nano at 64x64 (the JAX tool's ``init``, which the checkpoint
overwrites, gives zeros: ``torch_tools_util.TracedInit``).  XLA and PyTorch sum convolutions in other orders,
so detections differ in the last bits: each frame's boxes must agree
within 2e-3 px, the packed regions' fields within 5e-3; the mosaics'
count, names and sizes are equal, and each mosaic byte-equal unless one
of its regions' ``int()`` floors flipped between the two (a field within
5e-3 of an integer on both sides of it), which the test lists; the
annotations agree one to one, same image and category, bbox within
1e-2.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glsdet_tpu.eval.postprocess  # noqa: F401  (patched by name)
import glsdet_tpu.native  # noqa: F401
import glsdet_tpu.train.loop  # noqa: F401
from glsdet_tpu.ufp.packing import Region as JRegion
from glsdet_tpu_torch.tools import build_ufp_dataset as tool
from glsdet_tpu_torch.ufp.packing import Region as TRegion
from torch_tools_util import (COARSE_CLI, jax_checkpoint,
                              run_jax, traced_init_patch, write_set)

FRAMES = [(120, 200), (96, 160), (150, 100), (80, 130)]
K = 8                                    # padded detection rows


def _dets(i):
    """Frame ``i``'s fixed detections in the 64x64 input's coordinates:
    (K, 4) float32 rows and the valid mask."""
    boxes = np.zeros((K, 4), np.float32)
    valid = np.zeros((K,), bool)
    if i == 0:          # packs to a region corner 9.3e-4 below 57
        rs = np.random.RandomState(101)
        xy, wh = rs.uniform(0, 56, (4, 2)), rs.uniform(1.5, 10, (4, 2))
        boxes[:4] = np.round(np.concatenate([xy, xy + wh], 1), 3)
        valid[:4] = True
    elif i == 1:        # overhangs the frame's right and bottom edges
        boxes[:3] = [[50.5, 52.25, 70.0, 66.0], [3.0, 4.0, 9.5, 12.0],
                     [20.0, 20.0, 44.0, 30.0]]
        valid[:3] = True
    elif i == 3:
        rs = np.random.RandomState(7)
        xy, wh = rs.uniform(0, 54, (6, 2)), rs.uniform(2, 10, (6, 2))
        boxes[:6] = np.concatenate([xy, xy + wh], 1)
        valid[:6] = True
    return boxes, valid


def _gts():
    """GTs: each detection in frame pixels (the first of each frame a
    little jittered), and one box away from them."""
    gts = {}
    for i, (h, w) in enumerate(FRAMES):
        boxes, valid = _dets(i)
        b = boxes[valid] * np.array([w / 64, h / 64] * 2, np.float32)
        rows = [((x1, y1, x2 - x1, y2 - y1), j % 10)
                for j, (x1, y1, x2, y2) in enumerate(b)]
        if rows:
            x, y, bw, bh = rows[0][0]
            rows[0] = ((x + 0.7, y - 0.4, bw * 0.9, bh * 1.1), rows[0][1])
        rows.append(((w * 0.8, h * 0.1, 6.0, 5.0), 3))
        gts[i] = rows
    return gts


def _postprocess(kind):
    """A ``yolox_postprocess`` stand-in returning frame n's fixed
    detections at its n-th call, as jnp arrays or torch tensors."""
    calls = []

    def fn(*a, **kw):
        boxes, valid = _dets(len(calls))
        calls.append(kw)
        if kind == "jax":
            return {"boxes": jnp.asarray(boxes[None]),
                    "valid": jnp.asarray(valid[None])}
        return {"boxes": torch.from_numpy(boxes[None]),
                "valid": torch.from_numpy(valid[None])}

    fn.calls = calls
    return fn


def _unjitted_fwd():
    """``jax.jit`` that leaves the tool's per-frame ``_fwd`` eager."""
    import jax

    real = jax.jit

    def jit(f, *a, **kw):
        return f if getattr(f, "__name__", "") == "_fwd" else real(
            f, *a, **kw)

    return jit


class _NoModel:
    """Stands in for the JAX tool's model where the detections are fixed:
    nothing to initialise or run."""

    def init(self, *a, **kw):
        return {}

    def apply(self, *a, **kw):
        return None, None, None


def _recorder(pack):
    rec = []

    def fn(boxes, scale, input_shape, *a, **kw):
        out = pack(boxes, scale, input_shape, *a, **kw)
        rec.append((np.asarray(boxes, np.float64).copy(), input_shape, out))
        return out

    fn.rec = rec
    return fn


HAND_ROWS = [
    # x1, y1, w, h, new_x, new_y, factor
    (150.3, 90.7, 60.2, 40.9, 0.0, 0.0, 2),          # past right, bottom
    (-3.4, 10.2, 30.6, 20.1, 125.0, 0.0, 1),         # left of the frame
    (205.0, 5.0, 10.0, 10.0, 160.0, 30.0, 1),        # wholly outside
    (68.00016975, 11.9996, 20.0004, 15.5, 0.0, 85.0, 4),  # past mosaic
]
HAND_WH = (200.7, 130.5)


def _hand_packer(region_cls):
    def fn(boxes, scale, input_shape, *a, **kw):
        return ([region_cls(*row) for row in HAND_ROWS], *HAND_WH)

    return fn


def _read_out(out_dir):
    with open(os.path.join(out_dir, "ufp_train.json")) as f:
        coco = json.load(f)
    jpegs = {}
    for im in coco["images"]:
        with open(os.path.join(out_dir, "images", im["file_name"]),
                  "rb") as f:
            jpegs[im["file_name"]] = f.read()
    return coco, jpegs


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frames"))
    return write_set(root, FRAMES, gts=_gts(),
                     ignore={0: [(90.0, 40.0, 30.0, 25.0)]})


@pytest.mark.parametrize("packer", ["native", "hand_made"])
def test_equal_detections_write_an_equal_dataset(tmp_path, dataset, packer):
    ann, img_root = dataset
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["coarse_det", "none", ann, img_root]
    opts = ["--cfg-options", *COARSE_CLI]
    jpost, tpost = _postprocess("jax"), _postprocess("torch")
    if packer == "native":
        import glsdet_tpu.native as jnative

        jpack = _recorder(jnative.unified_foreground_packing_native)
        tpack = _recorder(tool.unified_foreground_packing_native)
    else:
        jpack, tpack = _hand_packer(JRegion), _hand_packer(TRegion)
    run_jax("build_ufp_dataset", [*args, jout, *opts], **{
        "glsdet_tpu.eval.postprocess:yolox_postprocess": jpost,
        "glsdet_tpu.native:unified_foreground_packing_native": jpack,
        "glsdet_tpu.train.loop:build_model": lambda cfg: _NoModel(),
        "jax:jit": _unjitted_fwd()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tool, "yolox_postprocess", tpost)
        mp.setattr(tool, "unified_foreground_packing_native", tpack)
        stats = tool.main([*args, tout, *opts, "--device", "cpu"])
    assert len(jpost.calls) == len(tpost.calls) == len(FRAMES)
    assert tpost.calls[0] == {"score_thr": 1e-4, "max_dets": 200}

    want, want_jpegs = _read_out(jout)
    got, got_jpegs = _read_out(tout)
    assert got == want
    assert got_jpegs.keys() == want_jpegs.keys()
    for name in want_jpegs:
        assert got_jpegs[name] == want_jpegs[name], name
    assert stats["mosaics"] == len(want["images"])
    assert stats["annotations"] == len(want["annotations"]) > 0
    if packer == "native":
        # frame 2 has no detection: 3 mosaics of 4 frames
        assert len(want["images"]) == 3
        regions = [r for _, _, (regs, _, _) in tpack.rec for r in regs]
        near = [v for r in regions for v in (r.x1, r.y1)
                if 0 < abs(v - round(v)) < 1e-3]
        assert near and any(int(v) != round(v) for v in near), near
        frame1 = tpack.rec[1][0]
        assert (frame1[:, 2] > FRAMES[1][1]).any() \
            and (frame1[:, 3] > FRAMES[1][0]).any()
    else:
        assert len(want["images"]) == len(FRAMES)
        assert [(im["width"], im["height"]) for im in want["images"]] \
            == [(200, 130)] * len(FRAMES)


def _floors(regions):
    return [tuple(int(v) for v in r.as_row()) for r in regions]


def _near_integer_between(a, b, tol):
    """``int()`` of a and b differ only because an integer lies between
    them, within ``tol`` of both."""
    k = max(np.floor(a), np.floor(b))
    return abs(a - k) <= tol and abs(b - k) <= tol


def test_shared_checkpoint_builds_the_same_dataset(tmp_path, dataset):
    import glsdet_tpu.native as jnative

    ann, img_root = dataset
    ckpt = jax_checkpoint(str(tmp_path / "ckpt"), "coarse_det", COARSE_CLI,
                          seed=3)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["coarse_det", ckpt, ann, img_root]
    opts = ["--cfg-options", *COARSE_CLI]
    jpack = _recorder(jnative.unified_foreground_packing_native)
    tpack = _recorder(tool.unified_foreground_packing_native)
    run_jax("build_ufp_dataset", [*args, jout, *opts], **{
        "glsdet_tpu.native:unified_foreground_packing_native": jpack,
        **traced_init_patch()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tool, "unified_foreground_packing_native", tpack)
        tool.main([*args, tout, *opts, "--device", "cpu"])

    assert len(jpack.rec) == len(tpack.rec) == len(FRAMES)
    flipped = []
    for i, ((jb, _, (jr, jw, jh)), (tb, _, (tr, tw, th))) in enumerate(
            zip(jpack.rec, tpack.rec)):
        assert jb.shape == tb.shape and len(jb) > 10, (jb.shape, tb.shape)
        np.testing.assert_allclose(tb, jb, atol=2e-3)
        assert len(jr) == len(tr)
        np.testing.assert_allclose([r.as_row() for r in tr],
                                   [r.as_row() for r in jr], atol=5e-3)
        np.testing.assert_allclose([tw, th], [jw, jh], atol=5e-3)
        for a, b in zip(_floors(jr) + [(int(jw), int(jh))],
                        _floors(tr) + [(int(tw), int(th))]):
            if a != b:
                flipped.append(i)
        for ra, rb in zip(jr, tr):
            for a, b in zip(ra.as_row(), rb.as_row()):
                if int(a) != int(b):
                    assert _near_integer_between(a, b, 5e-3), (i, a, b)

    want, want_jpegs = _read_out(jout)
    got, got_jpegs = _read_out(tout)
    assert len(want["images"]) == len(FRAMES) and got["images"] \
        and len(got["images"]) == len(want["images"])
    for gi, wi in zip(got["images"], want["images"]):
        assert gi["file_name"] == wi["file_name"]
        assert abs(gi["width"] - wi["width"]) <= 1
        assert abs(gi["height"] - wi["height"]) <= 1
    frame_of = {im["file_name"]: int(im["file_name"][4:11]) - 100
                for im in want["images"]}
    for name, data in want_jpegs.items():
        if frame_of[name] not in flipped:
            assert got_jpegs[name] == data, name
    assert got["categories"] == want["categories"]
    assert len(got["annotations"]) == len(want["annotations"]) > 0
    for ga, wa in zip(got["annotations"], want["annotations"]):
        assert (ga["image_id"], ga["category_id"]) == (wa["image_id"],
                                                      wa["category_id"])
        np.testing.assert_allclose(ga["bbox"], wa["bbox"], atol=1e-2)
    print("frames whose floors flipped:", sorted(set(flipped)))
