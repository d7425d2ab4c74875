"""Port parity of the slice as a whole: two-stage UFPMP inference with
MP-Det's identity bottlenecks fused, on the CPU.

The port's ``TwoStagePipeline(coarse, wrap_model_fused(MPDet(10, 50)),
device="cpu")`` against the JAX package's ``TwoStagePipeline(coarse_apply,
wrap_apply_fused(mp_apply), ...)`` (the Pallas kernel in interpret mode),
with the fixture sizes of tests/test_torch_two_stage.py: YOLOX-nano,
buckets (128, 256), 96x160 noise frames, the same flax weights.  At bucket
128 ResNet-50's layer4 runs at 4x4 and falls through (W < 8) while
layer1-3 fire; at 256 all four stages fire.

The fused blocks round their intermediates to bf16 in both packages, and
the two sum in another order, so an intermediate can round to its other
bf16 neighbour; the next block's bf16 input then rounds differently in
many places, and the flips cascade over the fused blocks until the two
fused MP-Dets differ about as much as either differs from its own float32
forward (measured at 128x128: 1.4e-2 of the output maximum between the
packages, 1.7e-2 and 1.9e-2 fused vs unfused in each).  With random
weights the ranked detections hold many near-ties, so the float
pipelines' tolerances (IoU > 0.99, scores within 1e-4) pair only ~5% of
the detections.  The checks, each with that slack: MP-Det's outputs on the
same input within 3e-2 of the maximum; stage 2 on the same region rows
and the whole ``run_batch`` by matching detections, >= 95% both ways, at
the same label, IoU > 0.5 and scores within 0.05 (measured: >= 97.9% of
``run_batch``'s; 88-93% at IoU > 0.9 and 0.01).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu import native as jnative
from glsdet_tpu.eval.two_stage import TwoStagePipeline as JPipeline
from glsdet_tpu.models import MPDet as JMPDet
from glsdet_tpu.models import YOLOXDetector as JYOLOX
from glsdet_tpu.ops.fused_infer import wrap_apply_fused
from glsdet_tpu_torch.eval.two_stage import TwoStagePipeline
from glsdet_tpu_torch.models import MPDet, YOLOXDetector
from glsdet_tpu_torch.models.resnet import ResNet
from glsdet_tpu_torch.ops.fused_infer import FusedBottleneck, wrap_model_fused
from test_torch_two_stage import BUCKETS, COARSE_HW, FRAME
from torch_port_util import flax_vars, load_flax, nchw, rand_nhwc


@pytest.fixture(scope="module")
def pipes():
    jc, jm = JYOLOX(num_classes=10, phi="nano"), JMPDet(num_classes=10,
                                                        depth=50)
    x = np.zeros((1, 64, 64, 3), np.float32)
    cvars = flax_vars(jc, x)
    mvars = flax_vars(jm, x)
    kw = dict(coarse_score_thr=1e-4, mosaic_buckets=BUCKETS, max_batch=4)
    jpipe = JPipeline(lambda v, im: jc.apply(v, im, train=False),
                      wrap_apply_fused(
                          lambda v, im: jm.apply(v, im, train=False)),
                      COARSE_HW, coarse_vars=jax.device_put(cvars),
                      mp_vars=jax.device_put(mvars),
                      mosaic_dtype=jnp.float32, painter="pallas",
                      pack_mode="bucket-fit", pack_threads=1, **kw)
    g = torch.Generator().manual_seed(0)
    mp = wrap_model_fused(load_flax(MPDet(10, 50, generator=g), mvars))
    tpipe = TwoStagePipeline(
        load_flax(YOLOXDetector(10, "nano", generator=g), cvars), mp,
        COARSE_HW, pack_mode="bucket-fit", pack_threads=1, device="cpu",
        **kw)
    yield jpipe, tpipe
    tpipe.close()


@pytest.fixture(scope="module")
def frames():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 256, (*FRAME, 3), np.uint8) for _ in range(3)]


def _matched(a, b):
    """Share of a's detections with a partner in b: same label, IoU > 0.5
    and |score difference| < 0.05 (module docstring)."""
    if not len(a["boxes"]):
        return 1.0
    hits = 0
    for box, s, lab in zip(a["boxes"], a["scores"], a["labels"]):
        o = b["boxes"][(b["labels"] == lab)
                       & (np.abs(b["scores"] - s) < 0.05)]
        lt = np.maximum(o[:, :2], box[:2])
        rb = np.minimum(o[:, 2:], box[2:])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
        area = lambda x: np.prod(x[..., 2:] - x[..., :2], axis=-1)  # noqa
        iou = inter / np.maximum(area(o) + area(box) - inter, 1e-9)
        hits += int((iou > 0.5).any())
    return hits / len(a["boxes"])


def _dets(packed):
    """(K, 7) packed rows -> the valid detections as a dict."""
    packed = np.asarray(packed)
    v = packed[:, 6] > 0.5
    return {"boxes": packed[v, :4], "scores": packed[v, 4],
            "labels": packed[v, 5].astype(np.int64)}


def _both_ways(got, want):
    m = (_matched(got, want), _matched(want, got))
    assert min(m) >= 0.95, m


def test_pipeline_holds_fused_blocks(pipes):
    _, tpipe = pipes
    fused = [m for m in tpipe.mp.modules() if isinstance(m, FusedBottleneck)]
    assert len(fused) == 12
    assert all(m.b1.dtype == torch.float32 for m in fused)


def test_mpdet_agrees_on_the_same_input(pipes):
    """Both pipelines' MP-Det at bucket 128, where layer4 falls through."""
    jpipe, tpipe = pipes
    x = rand_nhwc((1, 128, 128, 3), seed=1)
    want = jax.jit(jpipe._raw_mp_apply)(jpipe._mvars, jnp.asarray(x.copy()))
    with torch.inference_mode():
        got = tpipe.mp(nchw(x))
    for g_maps, w_maps in zip(got, want):
        for g, w in zip(g_maps, w_maps):
            w = np.asarray(w)
            err = np.abs(g.numpy() - w).max() / np.abs(w).max()
            assert err <= 3e-2, err


def test_stage2_agrees_on_the_same_region_rows(pipes, frames):
    jpipe, tpipe = pipes
    stack = np.stack(frames)
    coarse = np.asarray(jpipe._coarse_full_batch(jnp.asarray(stack.copy())))
    sx, sy = FRAME[1] / COARSE_HW[1], FRAME[0] / COARSE_HW[0]
    jobs = {}
    for i in range(len(frames)):
        boxes = (coarse[i, :, :4] * np.array([sx, sy, sx, sy], np.float32))[
            coarse[i, :, 6] > 0.5]
        rows, n_reg, _, _, bucket = \
            jnative.unified_foreground_packing_rows_fit(
                boxes, 1.5, (FRAME[1], FRAME[0]), 32, BUCKETS)
        assert n_reg > 0
        jobs.setdefault(bucket or BUCKETS[-1], []).append((i, rows))
    n_dets = 0
    for bucket, job in jobs.items():
        idx = np.array([j[0] for j in job], np.int32)
        regs = np.stack([j[1] for j in job])
        want = jpipe._mosaic_stage_batch(
            jnp.asarray(stack.copy()), jnp.asarray(idx),
            jnp.asarray(regs.copy()), jnp.asarray(regs.copy()), bucket)
        got = tpipe.stage2_packed(torch.from_numpy(stack.copy()),
                                  torch.from_numpy(idx.astype(np.int64)),
                                  torch.from_numpy(regs.copy()), bucket)
        for g, w in zip(got, np.asarray(want)):
            _both_ways(_dets(g), _dets(w))
            n_dets += len(_dets(g)["scores"])
    assert n_dets > 0


def test_run_batch_matches_and_stage2_fires(pipes, frames):
    jpipe, tpipe = pipes
    want = jpipe.run_batch([f.copy() for f in frames])
    h = tpipe.submit_batch([f.copy() for f in frames])
    tpipe.dispatch_mosaics(h)
    assert len(h.pending) >= 1                    # stage 2 ran
    got = tpipe.collect_batch(h)
    total = 0
    for g, w in zip(got, want):
        total += len(g["boxes"])
        _both_ways(g, w)
    assert total > 0


def test_fused_mpdet_with_quant8_raises():
    mp = wrap_model_fused(ResNet(50, base_channels=16))
    with pytest.raises(ValueError, match="float only"):
        TwoStagePipeline(torch.nn.Identity(), mp, COARSE_HW, quant8="static",
                         device="cpu")
