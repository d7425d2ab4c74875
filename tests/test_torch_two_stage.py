"""Port parity: the two-stage UFPMP pipeline end to end, on the CPU.

Tiny models (YOLOX-nano, MPDet depth 18) with the same flax weights,
coarse input 64x64, buckets (128, 256), noise frames of 96x160 and a
coarse score threshold of 1e-4.  The JAX pipeline paints with the Pallas
kernel in interpret mode; both run in float32 with one packing thread.

The flax init is used with its constant leaves jittered
(``torch_port_util.flax_vars``): at the plain init every coarse score
sits at the prior 1e-4 to within 1e-11, so the two frameworks' last-bit
differences reorder near-ties in the ranked output.  Jittered biases
spread the scores, every frame fires, and stage 2 runs.

Tolerances are those of tests/test_torch_postprocess.py (valid and
labels exact, boxes atol 1e-4, scores atol 1e-6) wherever both stacks
see the same inputs, except stage-2 scores (see below).  The whole ``run_batch`` is compared by matching
detections instead: UFP packing floors coordinates, so a 1e-6 box
difference in the coarse stage can move a chip by a pixel, and a moved
chip changes the detections that come out of it.
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
from glsdet_tpu_torch.eval.two_stage import TwoStagePipeline
from glsdet_tpu_torch.models import MPDet, YOLOXDetector
from torch_port_util import flax_vars, load_flax

COARSE_HW = (64, 64)
BUCKETS = (128, 256)
FRAME = (96, 160)


@pytest.fixture(scope="module")
def pipes():
    jc, jm = JYOLOX(num_classes=10, phi="nano"), JMPDet(num_classes=10,
                                                        depth=18)
    x = np.zeros((1, 64, 64, 3), np.float32)
    cvars = flax_vars(jc, x)
    mvars = flax_vars(jm, x, perturb=False)
    kw = dict(coarse_score_thr=1e-4, mosaic_buckets=BUCKETS, max_batch=4)
    jpipe = JPipeline(lambda v, im: jc.apply(v, im, train=False),
                      lambda v, im: jm.apply(v, im, train=False),
                      COARSE_HW, coarse_vars=jax.device_put(cvars),
                      mp_vars=jax.device_put(mvars),
                      mosaic_dtype=jnp.float32, painter="pallas",
                      pack_mode="bucket-fit", pack_threads=1, **kw)
    g = torch.Generator().manual_seed(0)
    tpipe = TwoStagePipeline(
        load_flax(YOLOXDetector(10, "nano", generator=g), cvars),
        load_flax(MPDet(10, 18, generator=g), mvars), COARSE_HW,
        pack_mode="bucket-fit", pack_threads=1, device="cpu", **kw)
    yield jpipe, tpipe
    tpipe.close()


@pytest.fixture(scope="module")
def frames():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 256, (*FRAME, 3), np.uint8) for _ in range(3)]


def _agree(got, want, score_atol=1e-6):
    """Packed (..., K, 7) ranked detection sets.  The valid masks must be
    equal, and the valid rows must pair up one to one with the same label,
    boxes within atol 1e-4 and scores within atol 1e-6.  Rows are paired
    rather than compared rank by rank because two detections whose
    scores agree to within the score tolerance (one ulp apart, here) may
    come out of either framework's sort in either order."""
    g = np.asarray(got).reshape(-1, *np.shape(got)[-2:])
    w = np.asarray(want).reshape(g.shape)
    np.testing.assert_array_equal(g[..., 6], w[..., 6])
    n = 0
    for gi, wi in zip(g, w):
        gi, wi = gi[gi[:, 6] > 0.5], wi[wi[:, 6] > 0.5]
        free = np.ones(len(wi), bool)
        for row in gi:
            ok = (free & (wi[:, 5] == row[5])
                  & (np.abs(wi[:, 4] - row[4]) <= score_atol)
                  & (np.abs(wi[:, :4] - row[:4]).max(-1) <= 1e-4))
            assert ok.any(), f"no partner for {row}"
            free[np.argmax(ok)] = False
        n += len(gi)
    return n


def test_coarse_detections_agree(pipes, frames):
    jpipe, tpipe = pipes
    stack = np.stack(frames)
    want = jpipe._coarse_full_batch(jnp.asarray(stack.copy()))
    got = tpipe.coarse_packed(torch.from_numpy(stack.copy()))
    assert _agree(got, want) >= 4


def test_stage2_agrees_on_the_same_region_rows(pipes, frames):
    jpipe, tpipe = pipes
    stack = np.stack(frames)
    coarse = np.asarray(jpipe._coarse_full_batch(jnp.asarray(stack.copy())))
    sx, sy = FRAME[1] / COARSE_HW[1], FRAME[0] / COARSE_HW[0]
    jobs = {}
    for i in range(len(frames)):
        boxes = (coarse[i, :, :4] * np.array([sx, sy, sx, sy], np.float32))[
            coarse[i, :, 6] > 0.5]
        rows, n_reg, mw, mh, bucket = \
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
        # MPDet's float32 logits differ by up to ~9e-6 between XLA's and
        # PyTorch's CPU convolutions (some twenty layers summed in other
        # orders; measured at this size), and the sigmoid's slope is at
        # most 1/4: stage-2 scores get 5e-6 instead of 1e-6
        n_dets += _agree(got, want, score_atol=5e-6)
    assert n_dets > 0


def test_stage2_agrees_at_a_bucket_that_crops(pipes, frames):
    """Bucket 384, which the JAX package paints at paint_hw_for(384) = 512
    and crops; the port paints at 384 (on the CPU through
    mosaic_inputs_plain, which crops as the JAX package does)."""
    jpipe, tpipe = pipes
    stack = np.stack(frames)
    coarse = np.asarray(jpipe._coarse_full_batch(jnp.asarray(stack.copy())))
    sx, sy = FRAME[1] / COARSE_HW[1], FRAME[0] / COARSE_HW[0]
    rows = []
    for i in range(len(frames)):
        boxes = (coarse[i, :, :4] * np.array([sx, sy, sx, sy], np.float32))[
            coarse[i, :, 6] > 0.5]
        rows.append(jnative.unified_foreground_packing_rows_fit(
            boxes, 1.5, (FRAME[1], FRAME[0]), 32, BUCKETS)[0])
    idx = np.arange(len(frames), dtype=np.int32)
    regs = np.stack(rows)
    want = jpipe._mosaic_stage_batch(
        jnp.asarray(stack.copy()), jnp.asarray(idx), jnp.asarray(regs.copy()),
        jnp.asarray(regs.copy()), 384)
    got = tpipe.stage2_packed(torch.from_numpy(stack.copy()),
                              torch.from_numpy(idx.astype(np.int64)),
                              torch.from_numpy(regs.copy()), 384)
    # stage-2 scores at 5e-6, as test_stage2_agrees_on_the_same_region_rows
    assert _agree(got, want, score_atol=5e-6) > 0


def _matched(a, b):
    """Share of a's detections with a partner in b: same label, IoU >
    0.99 and |score difference| < 1e-4."""
    if not len(a["boxes"]):
        return 1.0
    hits = 0
    for box, s, lab in zip(a["boxes"], a["scores"], a["labels"]):
        cand = (b["labels"] == lab) & (np.abs(b["scores"] - s) < 1e-4)
        if not cand.any():
            continue
        o = b["boxes"][cand]
        lt = np.maximum(o[:, :2], box[:2])
        rb = np.minimum(o[:, 2:], box[2:])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
        area = lambda x: np.prod(x[..., 2:] - x[..., :2], axis=-1)  # noqa
        iou = inter / np.maximum(area(o) + area(box) - inter, 1e-9)
        hits += int((iou > 0.99).any())
    return hits / len(a["boxes"])


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
        assert _matched(g, w) >= 0.95 and _matched(w, g) >= 0.95
    assert total > 0


def test_cuda_device_without_a_card_raises():
    """``device="cuda"`` never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        TwoStagePipeline(torch.nn.Identity(), torch.nn.Identity(), COARSE_HW,
                         device="cuda")


def test_warmup_then_device_batch_equals_run_batch(pipes, frames):
    """``warmup`` runs every bucket at batch 1 and ``max_batch`` on blank
    frames; afterwards the device-stack entry gives what ``run_batch``
    gives for the same frames."""
    _, tpipe = pipes
    tpipe.warmup(FRAME)
    want = tpipe.run_batch([f.copy() for f in frames])
    got = tpipe.run_device_batch(torch.from_numpy(np.stack(frames)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(g[key], w[key])
