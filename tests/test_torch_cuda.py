"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test takes the ``card`` fixture, which skips when
no CUDA device is present (decided inside the fixture, never at import,
so every xdist worker collects the same tests).  The machine with the
card has no JAX, so this file imports only torch, numpy and the port;
run it there with

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports jax).  The shapes are
the edges the serving path does not reach in ``chip_smoke.py``: K not a
multiple of 64, K = 1, 2048 and the 4096 maximum (the ring's 8, 7 and 6
stages), a single image, identical
boxes, canvases that are no multiple of the 8-row band or of 8 pixels,
zero and 1024 region rows, batch 1, and chips overhanging the canvas and
the frame.  Keep masks and the float32 canvas must be equal; the tap
weights are k/8, so the canvas is exact in any summation order.  The
painter's path entry (MP-Det's normalized bf16 input) must equal
``eval/preprocess.py: mosaic_inputs_plain``, the normalized 0 where no
chip paints.  The serving stages of a small pipeline (bf16, static int8,
fused) must run under ``torch.cuda.set_sync_debug_mode("error")``.

The GN kernel (GroupNorm -> ReLU -> int8 requant) is held against its
plain version with the slack of the f32 order of its statistics: codes
within +-1 and at most 1e-3 of them differing, except where noted.  The
int8 convolution's ``torch._int_mm`` route must equal its float64 version
at row counts around the GEMM's minimum of 17, which the route pads.

The fused bottleneck kernel is held against ``fused_bottleneck_plain``
within 5e-3 of the plain version's maximum (the two sum in another order,
so a bf16 intermediate can round to its other neighbour) at 4C = 64, 256
and 2048, odd and even H, W below and off the 16-pixel tile, one pixel;
``FusedBottleneck`` must take channels-last NCHW input and launch the
kernel once per eligible block.  The tile plan's edges: for every C, a
grid whose block count is no multiple of the cluster size, H and W off
the tile, images with fewer tiles than a cluster, batch 1 at the four
ResNet-50 stage shapes of the 1152 bucket, and two launches that must
agree bit for bit.

The serving facades' shapes: B2 at the global-local fusion's (16, 700),
offset 0, 0.65; the painter's path entry at the ladder's ends, 768² and
2688²; the GN kernel at every head level of the 1280-2688 buckets that
square packing can pick; and the no-sync test with ``fuse_global``.

MP-Det training (``train/steps.py``) at depth 18, feat_channels 64,
128x128, B = 2: one step makes no host sync; one step on the card
matches the CPU's (losses within 1e-4 relative, every leaf of the state
within 1e-5 of its max, TF32 off; the momentum buffers in float64 only);
remat on and off give the same losses and BN statistics; an image
without valid GTs gives finite losses.

The data pipeline's device stages (``data/device_color.py``,
``data/device_geom.py``) on the card against the same batch on the CPU:
HSV codes within +-1 (float32 division and rounding on either device;
the share that differs is reported in the assertion message), the
geometric warp within one code; ``ops/image.py: warp_affine_u8`` and
``resize_linear_u8`` equal to the CPU; and ``train/loop.py: train()``
from a PNG dataset on disk, whose steps make no host sync between the
loop's own reads.

Reading what users bring: ``run_eval`` on the card over JPEG frames gives
the detections it gives over PNGs of the pixels the port decodes from
them, and a ``TwoStageDetector`` built from reference-named checkpoints
that ``tools/import_torch_weights.py`` converted serves the detections of
one built from the port's own state-dict files.
"""

import functools
import json
import math
import os


import numpy as np
import pytest
import torch

from glsdet_tpu_torch.models import MPDet
from glsdet_tpu_torch.models.layers import flax_init_
from glsdet_tpu_torch.models.resnet import ResNet
from glsdet_tpu_torch.ops import bottleneck_kernel as bk
from glsdet_tpu_torch.ops import gn_kernel
from glsdet_tpu_torch.ops.fused_infer import FusedBottleneck, wrap_model_fused
from glsdet_tpu_torch.ops import nms as tnms
from glsdet_tpu_torch.ops import nms_kernel
from glsdet_tpu_torch.ops.int8_conv import Int8Conv2d
from glsdet_tpu_torch.eval.preprocess import (mosaic_inputs_plain,
                                              norm_constants)
from glsdet_tpu_torch.ufp import paint_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _det_boxes(rs, b, k, extent=500.0):
    centres = rs.uniform(0, extent, (b, max(k // 8, 1), 2))
    pick = rs.randint(0, centres.shape[1], (b, k))
    c = (np.take_along_axis(centres, pick[..., None], 1)
         + rs.normal(0, 6, (b, k, 2)))
    wh = rs.uniform(8, 60, (b, k, 2)) * rs.uniform(0.9, 1.1, (b, k, 1))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("b,k", [(1, 1), (2, 63), (1, 64), (3, 65),
                                 (2, 300), (1, 2047), (1, 2048),
                                 (1, 2400), (1, 3456), (1, 3457),
                                 (2, 4096)])
@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_nms_kernel_matches_plain(card, b, k, offset):
    rs = np.random.RandomState(k)
    boxes = torch.from_numpy(_det_boxes(rs, b, k)).to(card)
    valid = torch.from_numpy(rs.rand(b, k) > 0.1).to(card)
    before = nms_kernel.launches
    for thr in (0.5, 0.65):
        got = nms_kernel.nms_sorted_cuda(boxes, valid, thr, offset)
        want = tnms.nms_sorted_plain(boxes, valid, thr, offset)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert nms_kernel.launches == before + 2


def test_nms_kernel_identical_boxes_and_all_invalid(card):
    box = torch.tensor([10.0, 10.0, 50.0, 40.0], device=card)
    boxes = box.expand(2, 130, 4).contiguous()
    valid = torch.ones(2, 130, dtype=torch.bool, device=card)
    valid[1] = False
    got = nms_kernel.nms_sorted_cuda(boxes, valid, 0.5)
    assert got[0, 0] and int(got[0].sum()) == 1 and not got[1].any()


@pytest.mark.parametrize("k", [1, 65, 2048, 4096])
def test_nms_kernel_none_suppressed_and_all_invalid(card, k):
    """Disjoint boxes: every valid one is kept; no valid box: none is."""
    i = torch.arange(k, device=card, dtype=torch.float32)
    boxes = torch.stack([i * 10, i * 0, i * 10 + 5, i * 0 + 5], -1)[None]
    valid = torch.ones(1, k, dtype=torch.bool, device=card)
    assert bool(nms_kernel.nms_sorted_cuda(boxes, valid, 0.1).all())
    valid[:, 1::2] = False
    assert torch.equal(nms_kernel.nms_sorted_cuda(boxes, valid, 0.1), valid)
    assert not nms_kernel.nms_sorted_cuda(boxes, valid & False, 0.1).any()


# (B, K, offset, threshold) of the launches of one bf16 and one
# static-int8 run_device_batch at the smoke's fixture (chip_smoke.py's
# nms_path phases log them: the coarse YOLOX NMS, the chip GFL NMS and the
# unmapped class-wise NMS), the global-local fusion's class-wise NMS
# over 200 coarse + 500 local rows (the serve phase), and the GFL
# Detector's gfl_postprocess NMS on 4 frames (budget 4 * max_dets = 400;
# the gfl_int8 phase)
PATH_NMS_SHAPES = [(16, 800, 0.0, 0.65), (16, 2000, 0.0, 0.6),
                   (16, 500, 1.0, 0.6), (16, 700, 0.0, 0.65),
                   (4, 400, 0.0, 0.65)]


@pytest.mark.parametrize("b,k,offset,thr", PATH_NMS_SHAPES)
def test_nms_kernel_at_the_path_shapes(card, b, k, offset, thr):
    rs = np.random.RandomState(k)
    boxes = _det_boxes(rs, b, k, extent=1152.0)
    labels = rs.randint(0, 10, (b, k))
    boxes = torch.from_numpy((boxes + labels[..., None] * 8192.0)
                             .astype(np.float32)).to(card)
    valid = torch.from_numpy(rs.rand(b, k) > 0.2).to(card)
    before = len(nms_kernel.shapes)
    got = nms_kernel.nms_sorted_cuda(boxes, valid, thr, offset)
    want = tnms.nms_sorted_plain(boxes, valid, thr, offset)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert len(nms_kernel.shapes) == min(before + 1, 1024)
    assert nms_kernel.shapes[-1] == (b, k, offset, thr)


def test_nms_kernel_rejects_what_it_cannot_take(card):
    ok = torch.zeros(1, 8, 4, device=card)
    valid = torch.ones(1, 8, dtype=torch.bool, device=card)
    with pytest.raises(TypeError):
        nms_kernel.nms_sorted_cuda(ok.double(), valid, 0.5)
    with pytest.raises(ValueError):
        nms_kernel.nms_sorted_cuda(torch.zeros(1, 4097, 4, device=card),
                                   torch.ones(1, 4097, dtype=torch.bool,
                                              device=card), 0.5)
    with pytest.raises(ValueError):
        nms_kernel.nms_sorted_cuda(ok[:, ::2], valid[:, ::2], 0.5)


def test_batched_nms_on_the_card_equals_the_cpu(card):
    """The class shift puts coordinates near 8e4: the kernel's IoU must
    be the plain version's float expression, with nothing contracted."""
    rs = np.random.RandomState(5)
    boxes = _det_boxes(rs, 4, 2000)
    scores = np.round(rs.rand(4, 2000), 2).astype(np.float32)
    labels = rs.randint(0, 10, (4, 2000))
    for offset in (0.0, 1.0):
        args = [torch.from_numpy(a.copy()) for a in (boxes, scores, labels)]
        want = tnms.batched_nms(*args, 0.6, offset=offset)
        got = tnms.batched_nms(*[a.to(card) for a in args], 0.6,
                               offset=offset)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


def _rows(rs, b, r, src_hw, canvas):
    rows = np.zeros((b, r, 7), np.float32)
    for s in range(b):
        for i in range(rs.randint(0, r + 1)):
            f = rs.choice([1, 2, 4])
            w, h = rs.randint(1, 60, 2)
            # crops may hang over the frame (halo taps read 0 there) and
            # chips over the canvas (clipped)
            rows[s, i] = [rs.randint(-2, src_hw[1] - w + 3),
                          rs.randint(-2, src_hw[0] - h + 3), w, h,
                          rs.randint(0, canvas[1]), rs.randint(0, canvas[0]),
                          f]
    return rows


@pytest.mark.parametrize("out_hw,r", [((100, 130), 7), ((256, 256), 32),
                                      ((64, 40), 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paint_kernel_matches_plain(card, out_hw, r, dtype):
    rs = np.random.RandomState(sum(out_hw) + r)
    frames = torch.from_numpy(
        rs.randint(0, 256, (3, 90, 120, 3), np.uint8)).to(card)
    rows = torch.from_numpy(_rows(rs, 4, r, (90, 120), out_hw)).to(card)
    idx = torch.tensor([2, 0, 1, 2], device=card)
    before = paint_kernel.launches
    got = paint_kernel.assemble_mosaic_cuda_batch(frames, idx, rows,
                                                  *out_hw, dtype)
    want = paint_kernel.assemble_mosaic_plain_batch(frames, idx, rows,
                                                    *out_hw, dtype)
    torch.cuda.synchronize()
    assert paint_kernel.launches == before + 1
    assert got.shape == (4, *out_hw, 3) and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,r", [(1, 32), (4, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paint_kernel_many_rows_and_one_image(card, b, r, dtype):
    rs = np.random.RandomState(r + b)
    frames = torch.from_numpy(
        rs.randint(0, 256, (2, 90, 120, 3), np.uint8)).to(card)
    rows = torch.from_numpy(_rows(rs, b, r, (90, 120), (200, 136))).to(card)
    idx = torch.from_numpy(rs.randint(0, 2, b)).to(card)
    got = paint_kernel.assemble_mosaic_cuda_batch(frames, idx, rows, 200,
                                                  136, dtype)
    want = paint_kernel.assemble_mosaic_plain_batch(frames, idx, rows, 200,
                                                    136, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _mosaic_inputs(card, b, r, hw, seed):
    """Frames, slots and region rows (chips over the frame and the canvas)
    on the card, and the bf16 normalize constants."""
    rs = np.random.RandomState(seed)
    frames = torch.from_numpy(
        rs.randint(0, 256, (3, 90, 120, 3), np.uint8)).to(card)
    rows = torch.from_numpy(_rows(rs, b, r, (90, 120), (hw, hw))).to(card)
    idx = torch.from_numpy(rs.randint(0, 3, b)).to(card)
    return frames, idx, rows, norm_constants(torch.bfloat16, card)


@pytest.mark.parametrize("hw", [100, 130, 256])
@pytest.mark.parametrize("b,r", [(1, 7), (4, 0), (4, 32), (2, 1024)])
def test_paint_inputs_kernel_equals_the_plain_chain(card, hw, b, r):
    """The path entry paints at hw (no multiple of 8 or of the 8-row band
    at 100 and 130) and must equal mosaic_inputs_plain, which paints at
    paint_hw_for(hw), crops and normalizes in three bf16 ops."""
    frames, idx, rows, (mean, inv_std) = _mosaic_inputs(card, b, r, hw,
                                                        hw + b + r)
    before = paint_kernel.launches
    got = paint_kernel.paint_mosaic_inputs_cuda(frames, idx, rows, hw, mean,
                                                inv_std)
    want = mosaic_inputs_plain(frames, idx, rows, hw, torch.bfloat16)
    torch.cuda.synchronize()
    assert paint_kernel.launches == before + 1
    assert got.shape == (b, hw, hw, 3) and got.dtype == torch.bfloat16
    assert got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw", [768, 2688])
def test_paint_inputs_kernel_at_the_ladder_ends(card, hw):
    """The path entry at the smallest and the largest bucket of the
    serving ladder (square packing picks any of them), on 765x1360 frames
    with 64 chips per mosaic of up to 300 source pixels upscaled x1, x2
    or x4, over the canvas and the frame."""
    rs = np.random.RandomState(hw)
    frames = torch.from_numpy(
        rs.randint(0, 256, (3, 765, 1360, 3), np.uint8)).to(card)
    rows = np.zeros((4, 64, 7), np.float32)
    for s in range(4):
        for i in range(64):
            f = rs.choice([1, 2, 4])
            w, h = rs.randint(1, 300 // f + 1, 2)
            rows[s, i] = [rs.randint(-2, 1360 - w + 3),
                          rs.randint(-2, 765 - h + 3), w, h,
                          rs.randint(-8, hw), rs.randint(-8, hw), f]
    rows = torch.from_numpy(rows).to(card)
    idx = torch.tensor([2, 0, 1, 2], device=card)
    mean, inv_std = norm_constants(torch.bfloat16, card)
    before = paint_kernel.launches
    got = paint_kernel.paint_mosaic_inputs_cuda(frames, idx, rows, hw, mean,
                                                inv_std)
    want = mosaic_inputs_plain(frames, idx, rows, hw, torch.bfloat16)
    torch.cuda.synchronize()
    assert paint_kernel.launches == before + 1
    assert got.shape == (4, hw, hw, 3)
    assert torch.equal(got, want)


def test_paint_inputs_kernel_uncovered_is_the_normalized_zero(card):
    frames, idx, rows, (mean, inv_std) = _mosaic_inputs(card, 2, 4, 64, 5)
    rows[1] = 0                                # slot 1: no rows
    rows[0, :, 4:6] = 40                       # slot 0: chips from (40, 40)
    got = paint_kernel.paint_mosaic_inputs_cuda(frames, idx, rows, 64, mean,
                                                inv_std)
    zero = (torch.zeros(3, dtype=torch.bfloat16, device=card) - mean) \
        * inv_std
    torch.cuda.synchronize()
    assert torch.equal(got[1], zero.expand(64, 64, 3))
    assert torch.equal(got[0, :40, :], zero.expand(40, 64, 3))
    assert torch.equal(got[0, :, :40], zero.expand(64, 40, 3))
    assert torch.equal(got, mosaic_inputs_plain(frames, idx, rows, 64,
                                                torch.bfloat16))


def test_paint_inputs_kernel_rejects_what_it_cannot_take(card):
    frames, idx, rows, (mean, inv_std) = _mosaic_inputs(card, 2, 4, 64, 6)
    with pytest.raises(ValueError, match="mean"):
        paint_kernel.paint_mosaic_inputs_cuda(frames, idx, rows, 64,
                                              mean.float(), inv_std)
    with pytest.raises(ValueError, match="inv_std"):
        paint_kernel.paint_mosaic_inputs_cuda(frames, idx, rows, 64, mean,
                                              inv_std.cpu())
    with pytest.raises(ValueError, match="region rows"):
        paint_kernel.paint_mosaic_inputs_cuda(
            frames, idx, torch.zeros(2, 1025, 7, device=card), 64, mean,
            inv_std)
    with pytest.raises(ValueError, match="contiguous"):
        paint_kernel.paint_mosaic_inputs_cuda(frames[:, ::2], idx, rows, 64,
                                              mean, inv_std)


def _gn_inputs(card, b, hw, c, seed, offset=0.5, scale=1.5):
    g = torch.Generator(card).manual_seed(seed)
    y = (torch.randn(b, hw, hw, c, device=card, generator=g) * scale
         + torch.randn(c, device=card, generator=g) * offset)
    gamma = torch.rand(c, device=card, generator=g) + 0.5
    beta = torch.randn(c, device=card, generator=g) * 0.3
    return y, gamma, beta


def _gn_check(y, gamma, beta, s_out, share=1e-3):
    before = gn_kernel.launches
    got = gn_kernel.gn_relu_quant(y, gamma, beta, s_out)
    want = gn_kernel.gn_relu_quant_plain(y, gamma, beta, s_out)
    torch.cuda.synchronize()
    assert gn_kernel.launches == before + 1
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= share
    return got, want


@pytest.mark.parametrize("b,hw,c", [(1, 9, 256), (16, 9, 256),
                                    (1, 36, 256), (16, 36, 256),
                                    (2, 20, 128), (1, 1, 8), (3, 5, 288)])
def test_gn_kernel_matches_plain(card, b, hw, c):
    y, gamma, beta = _gn_inputs(card, b, hw, c, hw * c + b)
    got, _ = _gn_check(y.to(torch.bfloat16), gamma, beta, 0.03)
    assert got.dtype == torch.int8 and got.shape == y.shape


def test_gn_kernel_negative_group_gives_zero_codes(card):
    y, _, _ = _gn_inputs(card, 2, 16, 256, 1)
    y[..., 32:40] = -y[..., 32:40].abs() - 1.0
    gamma = torch.ones(256, device=card)
    beta = torch.full((256,), -10.0, device=card)  # every v < 0: relu
    got, want = _gn_check(y.to(torch.bfloat16), gamma, beta, 0.05)
    assert int(got.abs().max()) == 0 and int(want.abs().max()) == 0


def test_gn_kernel_large_mean_offset(card):
    """mean 20 against a standard deviation of 1: E[y^2] - mean^2 cancels
    most of its digits, in both versions alike."""
    y, gamma, beta = _gn_inputs(card, 4, 32, 256, 7, offset=0.0, scale=1.0)
    _gn_check((y + 20.0).to(torch.bfloat16), gamma, beta, 0.03, share=5e-3)


def test_gn_kernel_constant_group_is_exact(card):
    y, gamma, beta = _gn_inputs(card, 2, 18, 256, 3)
    y[..., 64:72] = 0.75
    got, want = _gn_check(y.to(torch.bfloat16), gamma, beta, 0.03)
    assert torch.equal(got[..., 64:72], want[..., 64:72])


def test_gn_kernel_rejects_what_it_cannot_take(card):
    y, gamma, beta = _gn_inputs(card, 1, 8, 256, 0)
    yb = y.to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        gn_kernel.gn_relu_quant(yb.transpose(1, 2), gamma, beta, 0.03)
    with pytest.raises(TypeError):
        gn_kernel.gn_relu_quant(y, gamma, beta, 0.03)        # float32
    with pytest.raises(ValueError, match="C ="):
        gn_kernel.gn_relu_quant(yb[..., :100].contiguous(), gamma[:100],
                                beta[:100], 0.03)
    with pytest.raises(ValueError, match="gamma"):
        gn_kernel.gn_relu_quant(yb, gamma.double(), beta, 0.03)


def _acc_inputs(card, b, h, w, c, seed, scale=3000.0, offset=800.0):
    """int32 accumulators of an int8 convolution's magnitude, QConv-like
    per-channel dequantization scales, and a GN affine."""
    g = torch.Generator(card).manual_seed(seed)
    acc = (torch.randn(b, h, w, c, device=card, generator=g) * scale
           + torch.randn(c, device=card, generator=g) * offset
           ).round().to(torch.int32)
    deq = (torch.rand(c, device=card, generator=g) + 0.5) * (0.03 / 127)
    gamma = torch.rand(c, device=card, generator=g) + 0.5
    beta = torch.randn(c, device=card, generator=g) * 0.3
    return acc, deq, gamma, beta


def _acc_check(acc, deq, gamma, beta, s_out, share=1e-3, lively=True):
    before = gn_kernel.launches
    got = gn_kernel.gn_relu_quant_acc(acc, deq, gamma, beta, s_out)
    want = gn_kernel.gn_relu_quant_acc_plain(acc, deq, gamma, beta, s_out,
                                             min(32, acc.shape[-1]))
    torch.cuda.synchronize()
    assert gn_kernel.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == acc.shape
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= share
    if lively:                                       # not all clipped
        assert float((want != 0).float().mean()) > 0.2
    return got, want


@pytest.mark.parametrize("hw", [144, 72, 36, 18, 9, 128, 64, 32, 16, 8])
def test_gn_acc_kernel_matches_plain_at_every_level(card, hw):
    """The head levels of both buckets at the path's batch and width; the
    regime is the one the card grants (72 and 64 resident only where a
    cluster of 16 is)."""
    acc, deq, gamma, beta = _acc_inputs(card, 16, hw, hw, 256, hw)
    _acc_check(acc, deq, gamma, beta, 0.03)
    plan = gn_kernel.plan(torch.int32, 16, hw, hw, 256)
    if hw >= 128:
        assert plan["regime"] == "streaming"
    elif hw <= 36:
        assert plan["regime"] == "resident" and plan["cluster"] <= 8
    elif plan["regime"] == "resident":
        assert plan["cluster"] == 16


# the head levels (strides 8-128) of the buckets square packing picks
# beyond 1024/1152: 1280, 1536, 1792 and 2688
SQUARE_LEVELS = [160, 80, 40, 20, 10, 192, 96, 48, 24, 12, 224, 112, 56, 28,
                 14, 336, 168, 84, 42, 21]


@pytest.mark.parametrize("hw", SQUARE_LEVELS)
def test_gn_acc_kernel_at_the_larger_buckets_levels(card, hw):
    """Every level of the larger buckets at the serving batch of 8, in the
    regime the card grants it; levels above 144 are streamed."""
    acc, deq, gamma, beta = _acc_inputs(card, 8, hw, hw, 256, hw + 7)
    _acc_check(acc, deq, gamma, beta, 0.03)
    plan = gn_kernel.plan(torch.int32, 8, hw, hw, 256)
    if hw > 144:
        assert plan["regime"] == "streaming"


@pytest.mark.parametrize("c", [8, 64, 256, 2048])
@pytest.mark.parametrize("h,w", [(9, 9), (37, 35), (145, 143)])
def test_gn_acc_kernel_one_image_odd_sizes(card, c, h, w):
    acc, deq, gamma, beta = _acc_inputs(card, 1, h, w, c, c + h)
    _acc_check(acc, deq, gamma, beta, 0.03)


@pytest.mark.parametrize("hw", [9, 36, 72, 144])
def test_gn_acc_kernel_constant_and_negative_groups(card, hw):
    acc, deq, gamma, beta = _acc_inputs(card, 2, hw, hw, 256, 5)
    acc[..., 64:72] = 3072
    deq[64:72] = 2.0 ** -12                      # y = 0.75 exactly
    got, want = _acc_check(acc, deq, gamma, beta, 0.03)
    assert torch.equal(got[..., 64:72], want[..., 64:72])
    acc[..., 32:40] = -acc[..., 32:40].abs() - 1000
    beta = torch.full_like(beta, -10.0)          # every v < 0: relu
    got, want = _acc_check(acc, deq, torch.ones_like(gamma), beta, 0.05,
                           lively=False)
    assert int(got.abs().max()) == 0 and int(want.abs().max()) == 0


@pytest.mark.parametrize("hw", [144, 72, 36, 18, 9])
def test_gn_kernels_equal_plain_where_the_sums_are_exact(card, hw):
    """Accumulators in [-8, 8] at deq = 1/8: every partial sum of y and y*y
    is exact in f32 in any order, so the statistics agree to the bit and
    the codes must be equal: the affine, the bf16 round and the requant's
    division are the plain version's, element for element."""
    g = torch.Generator(card).manual_seed(hw)
    acc = torch.randint(-8, 9, (2, hw, hw, 256), device=card, generator=g,
                        dtype=torch.int32)
    deq = torch.full((256,), 0.125, device=card)
    gamma = torch.rand(256, device=card, generator=g) + 0.5
    beta = torch.randn(256, device=card, generator=g) * 0.3
    for s_out in (0.0137, 0.03, 0.11):
        got = gn_kernel.gn_relu_quant_acc(acc, deq, gamma, beta, s_out)
        want = gn_kernel.gn_relu_quant_acc_plain(acc, deq, gamma, beta, s_out)
        assert torch.equal(got, want)
        y = (acc.float() * deq).to(torch.bfloat16)
        assert torch.equal(gn_kernel.gn_relu_quant(y, gamma, beta, s_out),
                           want)


@pytest.mark.parametrize("hw", [9, 36, 72, 144])
def test_gn_acc_kernel_near_two_to_the_24(card, hw):
    """Accumulators around +-2**24, where int32 -> f32 rounds: the acc
    entry equals the bf16 entry fed (acc.float() * deq).to(bfloat16)
    code for code (same sums in the same order), and both are within
    +-1 of the plain version."""
    g = torch.Generator(card).manual_seed(hw)
    sign = torch.where(torch.rand(256, device=card, generator=g) > 0.5,
                       1, -1)
    acc = (sign * (2 ** 24 + torch.randint(-2 ** 21, 2 ** 21,
                                           (2, hw, hw, 256), device=card,
                                           generator=g))).to(torch.int32)
    deq = torch.rand(256, device=card, generator=g) * 1e-6 + 5e-7
    gamma = torch.rand(256, device=card, generator=g) + 0.5
    beta = torch.randn(256, device=card, generator=g) * 0.3
    got, _ = _acc_check(acc, deq, gamma, beta, 0.03)
    y = (acc.float() * deq).to(torch.bfloat16)
    assert torch.equal(got, gn_kernel.gn_relu_quant(y, gamma, beta, 0.03))


@pytest.mark.parametrize("hw", [9, 36, 72, 144])
def test_gn_kernels_are_deterministic(card, hw):
    acc, deq, gamma, beta = _acc_inputs(card, 4, hw, hw, 256, 9)
    y = (acc.float() * deq).to(torch.bfloat16)
    for fn, args in ((gn_kernel.gn_relu_quant_acc, (acc, deq)),
                     (gn_kernel.gn_relu_quant, (y,))):
        first = fn(*args, gamma, beta, 0.03)
        for _ in range(3):
            assert torch.equal(fn(*args, gamma, beta, 0.03), first)


@pytest.mark.parametrize("hw", [144, 36])
def test_gn_acc_kernel_on_two_streams_at_once(card, hw):
    """Two streams run the entry at once, each on its own inputs (144:
    the streaming regime's workspace and counters, 36: resident); both
    agree with the plain version, and the streams' last results equal
    their first."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    inputs = [_acc_inputs(card, 8, hw, hw, 256, 20 + i) for i in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(4):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(gn_kernel.gn_relu_quant_acc(*inputs[i],
                                                           0.03))
    torch.cuda.synchronize()
    for (acc, deq, gamma, beta), got in zip(inputs, outs):
        want = gn_kernel.gn_relu_quant_acc_plain(acc, deq, gamma, beta, 0.03)
        d = (got[0].int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
        assert all(torch.equal(o, got[0]) for o in got[1:])


def test_gn_acc_kernel_in_a_cuda_graph(card):
    """A graph captured over the streaming regime replays right after
    eager calls of a larger batch on the capturing stream and others."""
    acc, deq, gamma, beta = _acc_inputs(card, 2, 144, 144, 256, 31)
    want = gn_kernel.gn_relu_quant_acc(acc, deq, gamma, beta, 0.03)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = gn_kernel.gn_relu_quant_acc(acc, deq, gamma, beta, 0.03)
    big = _acc_inputs(card, 6, 144, 144, 256, 32)
    torch.cuda.synchronize()
    for st in (side, torch.cuda.current_stream()):
        with torch.cuda.stream(st):
            _acc_check(*big, 0.03)
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_gn_acc_kernel_rejects_what_it_cannot_take(card):
    acc, deq, gamma, beta = _acc_inputs(card, 1, 8, 8, 256, 0)
    with pytest.raises(ValueError, match="contiguous"):
        gn_kernel.gn_relu_quant_acc(acc.transpose(1, 2), deq, gamma, beta,
                                    0.03)
    with pytest.raises(TypeError):
        gn_kernel.gn_relu_quant_acc(acc.float(), deq, gamma, beta, 0.03)
    with pytest.raises(TypeError):                 # the kernel's is bf16
        gn_kernel.gn_relu_quant_acc(acc, deq, gamma, beta, 0.03,
                                    dtype=torch.float32)
    with pytest.raises(ValueError, match="C ="):
        gn_kernel.gn_relu_quant_acc(acc[..., :100].contiguous(), deq[:100],
                                    gamma[:100], beta[:100], 0.03)
    with pytest.raises(ValueError, match="deq"):
        gn_kernel.gn_relu_quant_acc(acc, deq[:128], gamma, beta, 0.03)
    for s_out in (0.0, -0.03, float("inf"), 1e-40):
        with pytest.raises(ValueError, match="s_out"):
            gn_kernel.gn_relu_quant_acc(acc, deq, gamma, beta, s_out)


@pytest.mark.parametrize("rows", [1, 15, 16, 17, 18, 24])
@pytest.mark.parametrize("cin,cout,k", [(64, 64, 1), (20, 36, 3)])
def test_int8_conv_gemm_rows_padded_and_exact(card, rows, cin, cout, k):
    g = torch.Generator(card).manual_seed(rows)
    x = torch.randint(-127, 128, (1, 1, rows, cin), dtype=torch.int8,
                      device=card, generator=g)
    q_w = torch.randint(-127, 128, (cout, cin, k, k), dtype=torch.int8,
                        device=card, generator=g)
    conv = Int8Conv2d(q_w, 1, k // 2)
    got = conv(x)
    torch.cuda.synchronize()
    assert got.shape == (1, 1, rows, cout)
    assert torch.equal(got, conv(x, plain=True))


def _bottleneck_inputs(card, b, h, w, cin, seed):
    """bf16 post-ReLU x and folded-like weights scaled by 1/sqrt(fan-in)."""
    g = torch.Generator(card).manual_seed(seed)
    c = cin // 4

    def rnd(*shape, scale=0.1):
        return torch.randn(*shape, device=card, generator=g) * scale

    x = torch.relu(rnd(b, h, w, cin, scale=1.0)).to(torch.bfloat16)
    return x, [rnd(cin, c, scale=1 / math.sqrt(cin)).to(torch.bfloat16),
               rnd(c), rnd(9 * c, c, scale=1 / math.sqrt(9 * c)).to(
                   torch.bfloat16), rnd(c),
               rnd(c, cin, scale=1 / math.sqrt(c)).to(torch.bfloat16),
               rnd(cin)]


def _bottleneck_check(x, ws):
    before = bk.launches
    got = bk.fused_bottleneck(x, *ws)
    want = bk.fused_bottleneck_plain(x, *ws)
    torch.cuda.synchronize()
    assert bk.launches == before + 1
    assert got.shape == x.shape and got.dtype == x.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err <= 5e-3 * float(want.float().abs().max()), err
    return got


@pytest.mark.parametrize("h,w", [(7, 10), (8, 12), (10, 37)])
@pytest.mark.parametrize("cin", [64, 256, 2048])
def test_bottleneck_kernel_matches_plain(card, cin, h, w):
    _bottleneck_check(*_bottleneck_inputs(card, 2, h, w, cin, h * w + cin))


@pytest.mark.parametrize("cin", [64, 512])
def test_bottleneck_kernel_one_pixel(card, cin):
    """Every 3x3 tap but the centre reads the zero padding."""
    _bottleneck_check(*_bottleneck_inputs(card, 3, 1, 1, cin, cin))


def test_bottleneck_kernel_float32_input(card):
    x, ws = _bottleneck_inputs(card, 1, 6, 20, 128, 11)
    got = _bottleneck_check(x.float(), ws)
    assert got.dtype == torch.float32


def test_bottleneck_kernel_rejects_what_it_cannot_take(card):
    x, ws = _bottleneck_inputs(card, 1, 8, 8, 256, 0)
    for cin in (32, 192):                               # C = 8, C = 48
        x_c, ws_c = _bottleneck_inputs(card, 1, 8, 8, cin, 0)
        with pytest.raises(ValueError, match="4C ="):
            bk.fused_bottleneck(x_c, *ws_c)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        bk.fused_bottleneck(x.transpose(1, 2), *ws)
    with pytest.raises(ValueError, match="w2"):
        bk.fused_bottleneck(x, *ws[:2], ws[2][:-1], *ws[3:])
    with pytest.raises(ValueError, match="b3"):
        bk.fused_bottleneck(x, *ws[:5], ws[5].cpu())
    with pytest.raises(TypeError):
        bk.fused_bottleneck(x.to(torch.int32), *ws)


@pytest.mark.parametrize("c", bk.KERNEL_C)
def test_bottleneck_kernel_ragged_tiles_and_clusters(card, c):
    """17 x 33: H off every TH, W off the 16-pixel tile, and 9 (TH = 8)
    or 15 (TH = 4) tiles, no multiple of a cluster of 2 or 4: the last
    cluster has spare blocks."""
    _bottleneck_check(*_bottleneck_inputs(card, 1, 17, 33, 4 * c, c + 1))


@pytest.mark.parametrize("c", [128, 256, 512])
def test_bottleneck_kernel_images_smaller_than_a_cluster(card, c):
    """One tile per image (3 x 10): a cluster spans images, and with 3
    images the grid's last cluster is mostly spare."""
    _bottleneck_check(*_bottleneck_inputs(card, 3, 3, 10, 4 * c, c + 2))


@functools.lru_cache(maxsize=None)
def _stage_block(name):
    """The seeded MP-Det's first identity block of a ResNet-50 stage,
    folded, in bf16 on the card (as ``chip_smoke.py`` takes it)."""
    mp = MPDet(10, 50, generator=torch.Generator().manual_seed(0))
    return FusedBottleneck(getattr(mp.backbone, f"{name}_1")).eval().to(
        "cuda", torch.bfloat16)


@pytest.mark.parametrize("name,hw", [("layer1", 288), ("layer2", 144),
                                     ("layer3", 72), ("layer4", 36)])
def test_bottleneck_kernel_batch_one_at_stage_shapes(card, name, hw):
    """Batch 1 at the stage shapes of the 1152 bucket, with the path's
    folded weights and packed buffers."""
    block = _stage_block(name)
    g = torch.Generator(card).manual_seed(hw)
    x = torch.relu(torch.randn(1, hw, hw, block.w1.shape[0], device=card,
                               generator=g)).to(torch.bfloat16)
    ws = (block.w1, block.b1, block.w2, block.b2, block.w3, block.b3)
    got = bk.fused_bottleneck(x, *ws, packed=(block.w1p, block.w2p,
                                              block.w3p))
    want = bk.fused_bottleneck_plain(x, *ws)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= 5e-3 * float(want.float().abs().max()), err


@pytest.mark.parametrize("hw,cin", [(72, 1024), (36, 2048)])
def test_bottleneck_kernel_is_deterministic(card, hw, cin):
    """No atomics and no order dependence: two launches, equal bits."""
    x, ws = _bottleneck_inputs(card, 4, hw, hw, cin, 7)
    first = bk.fused_bottleneck(x, *ws)
    second = bk.fused_bottleneck(x, *ws)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_bottleneck_kernel_prepacked_equals_packed_on_the_fly(card):
    x, ws = _bottleneck_inputs(card, 2, 16, 40, 1024, 3)
    packed = bk.pack_weights(ws[0], ws[2], ws[4])
    got = bk.fused_bottleneck(x, *ws, packed=packed)
    assert torch.equal(got, bk.fused_bottleneck(x, *ws))
    with pytest.raises(ValueError, match="packed"):
        bk.fused_bottleneck(x, *ws, packed=(packed[0], packed[1],
                                            packed[2][:-8]))


@pytest.fixture
def fused_resnet(card):
    """ResNet-50 at base width 16 in bf16 on the card, wrapped, in eval
    mode; the same weights unwrapped."""
    g = torch.Generator().manual_seed(0)
    ref = flax_init_(ResNet(50, base_channels=16), g).eval()
    model = wrap_model_fused(
        flax_init_(ResNet(50, base_channels=16), g.manual_seed(0)).eval())
    place = dict(device=card, dtype=torch.bfloat16)
    return model.to(**place), ref.to(**place)


def test_fused_block_takes_channels_last_input(card, fused_resnet):
    model, _ = fused_resnet
    block = model.layer1_1
    assert isinstance(block, FusedBottleneck)
    x = torch.relu(torch.randn(2, 64, 16, 24, device=card)).to(torch.bfloat16)
    xl = x.contiguous(memory_format=torch.channels_last)
    before = bk.launches
    with torch.inference_mode():
        got_cl, got = block(xl), block(x)
        want = bk.fused_bottleneck_plain(
            xl.permute(0, 2, 3, 1), block.w1, block.b1, block.w2, block.b2,
            block.w3, block.b3).permute(0, 3, 1, 2)
    torch.cuda.synchronize()
    assert bk.launches == before + 2
    assert got_cl.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got_cl, got)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 5e-3 * float(want.float().abs().max())


def test_fused_resnet_launches_once_per_eligible_block(card, fused_resnet):
    """At 64x64 layer1 (16x16, 2 identity blocks) and layer2 (8x8, 3)
    fire; layer3 (4x4) and layer4 (2x2) fall through: 5 launches."""
    model, ref = fused_resnet
    x = torch.randn(2, 3, 64, 64, device=card).to(torch.bfloat16)
    before = bk.launches
    with torch.inference_mode():
        got, want = model(x), ref(x)
    torch.cuda.synchronize()
    assert bk.launches == before + 5
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        rel = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert rel < 0.15, rel


def _small_pipeline(card, mode):
    """A small two-stage pipeline on the card: YOLOX-nano at 64x64,
    MP-Det ResNet-18, buckets 128/256, seeded weights; bf16, static int8
    (calibrated by a bf16 pipeline), fused, or bf16 with global-local
    fusion."""
    from glsdet_tpu_torch.eval.two_stage import TwoStagePipeline
    from glsdet_tpu_torch.models import YOLOXDetector

    def models():
        g = torch.Generator().manual_seed(0)
        return YOLOXDetector(10, "nano", generator=g), MPDet(10, 18,
                                                             generator=g)

    kw = dict(coarse_score_thr=1e-6, mosaic_buckets=(128, 256), max_batch=4,
              pack_threads=1, device=card)
    if mode == "fused":
        coarse, mp = models()
        return TwoStagePipeline(coarse, wrap_model_fused(mp), (64, 64), **kw)
    if mode == "fuse_global":
        return TwoStagePipeline(*models(), (64, 64), fuse_global=True, **kw)
    pipe = TwoStagePipeline(*models(), (64, 64), **kw)
    if mode == "bf16":
        return pipe
    rs = np.random.RandomState(1)
    scales = pipe.calibrate_int8(
        [rs.randint(0, 256, (96, 160, 3), np.uint8) for _ in range(2)])
    pipe.close()
    return TwoStagePipeline(*models(), (64, 64), quant8="static",
                            act_scales=scales, **kw)


@pytest.mark.parametrize("mode", ["bf16", "static_int8", "fused",
                                  "fuse_global"])
def test_serving_stages_do_not_sync_with_the_host(card, mode):
    """coarse_packed and stage2_packed (with the fusion's coarse sets under
    fuse_global) under set_sync_debug_mode("error"): no op inside them may
    wait for the card.  The transfers between the stages (the coarse
    read-back, the upload of the rows and coarse sets) sync by design and
    stay outside."""
    from glsdet_tpu_torch.eval.two_stage import (_scale_packed,
                                                 unpack_detections)

    pipe = _small_pipeline(card, mode)
    rs = np.random.RandomState(0)
    frames = torch.from_numpy(
        rs.randint(0, 256, (4, 96, 160, 3), np.uint8)).to(card)
    try:
        pipe.run_device_batch(frames)           # builds, plans, caches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            packed = pipe.coarse_packed(frames)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        packed_np = packed.cpu().numpy()
        dets = unpack_detections(packed_np)
        jobs = pipe._pack_chunk([(96, 160)] * 4, list(range(4)), dets)
        assert jobs
        for bucket, job_list in jobs.items():
            rows = [j[1] for j in job_list]
            idx = torch.tensor(rows).to(card)
            regs = torch.from_numpy(
                np.stack([j[2] for j in job_list])).to(card)
            gdets = (torch.from_numpy(_scale_packed(
                packed_np[rows], 160 / 64, 96 / 64)).to(card)
                if pipe.fuse_global else None)
            before = (paint_kernel.launches, nms_kernel.launches)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = pipe.stage2_packed(frames, idx, regs, bucket, gdets)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            # B2: the chips' decode, the unmapped chips and the fusion
            assert (paint_kernel.launches, nms_kernel.launches) == (
                before[0] + 1, before[1] + 2 + pipe.fuse_global)
            assert out.shape == (len(job_list), pipe.max_chip, 7)
            assert torch.isfinite(out).all()
    finally:
        pipe.close()


# MP-Det training at a small size


def _train_setup(device, remat=False, seed=0):
    """A seeded depth-18 MP-Det train state (beta 1) and its step; the
    dictionary is drawn on the CPU so every device starts from it."""
    from glsdet_tpu_torch.train import schedules
    from glsdet_tpu_torch.train.boiw import enable_emd_training, init_boiw
    from glsdet_tpu_torch.train.state import TrainState
    from glsdet_tpu_torch.train.steps import make_mpdet_train_step

    proxies = (2, 3, 2, 5, 4, 8, 8, 4, 3, 3)
    model = MPDet(10, 18, 64, proxies, remat=remat,
                  generator=torch.Generator().manual_seed(seed)).to(device)
    opt = schedules.mp_det_sgd(model.parameters(),
                               schedules.schedule_1x(0.01, 100))
    boiw = enable_emd_training(init_boiw(
        torch.Generator().manual_seed(seed), 10, 16, 64, proxies,
        device="cpu"))
    boiw = type(boiw)(*(t.to(device) for t in boiw))
    gen = torch.Generator(device=device).manual_seed(seed)
    state = TrainState.create(model, opt, gen, boiw=boiw)
    step = make_mpdet_train_step(model, (128, 128), 10, proxies,
                                 normalize=True)
    return state, step


def _train_batch(device, seed=0, b=2, g=4, empty_image=None):
    rs = np.random.RandomState(seed)
    x1, y1 = rs.uniform(0, 80, (b, g)), rs.uniform(0, 80, (b, g))
    wh = rs.uniform(8, 40, (b, g, 2))
    boxes = np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]], -1)
    valid = np.ones((b, g), bool)
    valid[:, -1] = False
    if empty_image is not None:
        valid[empty_image] = False
    batch = {"images": rs.randint(0, 255, (b, 128, 128, 3)).astype(np.uint8),
             "gt_boxes": boxes.astype(np.float32),
             "gt_labels": rs.randint(0, 10, (b, g)).astype(np.int64),
             "gt_valid": valid}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _noise(b=2):
    n = b * (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1)
    return torch.rand(11, n, generator=torch.Generator().manual_seed(9))


def test_train_step_does_not_sync_with_the_host(card):
    state, step = _train_setup(card)
    batch = _train_batch(card)
    state, _ = step(state, batch)                # warm: plans, buffers
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def _jitter_bn(model, seed=1) -> None:
    """Biases, BN scales and BN statistics off their constant inits (the
    same numbers on every device), so that no leaf's max is the step's
    own update."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            bias = getattr(m, "bias", None)
            if isinstance(bias, torch.nn.Parameter):
                bias.copy_(torch.from_numpy(0.1 * rs.randn(*bias.shape)))
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                for t, v in ((m.weight, 1.0 + 0.1 * rs.randn(c)),
                             (m.running_mean, 0.1 * rs.randn(c)),
                             (m.running_var, 0.5 + rs.rand(c))):
                    t.copy_(torch.from_numpy(v))


def _train_leaves(state):
    named = dict(state.model.named_parameters())
    return {"state": state.model.state_dict(),
            "momentum": {n: state.optimizer.state[p]["momentum_buffer"]
                         for n, p in named.items()},
            "ema": state.ema_params,
            "boiw": {"embedding": state.boiw.embedding}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_train_step_on_the_card_matches_the_cpu(card, dtype):
    """One step of the same seeded state on the CPU and on the card (TF32
    off): losses within 1e-4 relative, every leaf within 1e-5 of its max.
    In float32 the momentum buffers (the gradients) are left out: the
    backbone's BN gradients of this fixture are the remainder of a
    cancellation and carry percent-level rounding on any device
    (tests/test_torch_train_step.py); float64 holds them."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for dev in (torch.device("cpu"), card):
            state, _ = _train_setup(dev)
            _jitter_bn(state.model)
            state.model.to(dtype)
            state.ema_params = {n: p.detach().clone() for n, p in
                                state.model.named_parameters()}
            from glsdet_tpu_torch.train.steps import make_mpdet_train_step
            step = make_mpdet_train_step(
                state.model, (128, 128), 10, (2, 3, 2, 5, 4, 8, 8, 4, 3, 3),
                normalize=True)
            state, metrics = step(state, _train_batch(dev),
                                  noise=_noise().to(dev))
            runs.append((_train_leaves(state), metrics))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (cl, cm), (gl, gm) = runs
    for k in cm:
        torch.testing.assert_close(gm[k].cpu(), cm[k], rtol=1e-4, atol=0)
    for kind, leaves in cl.items():
        if kind == "momentum" and dtype == torch.float32:
            continue
        for name, want in leaves.items():
            want, got = want.double(), gl[kind][name].cpu().double()
            err = float((got - want).abs().max())
            scale = max(float(want.abs().max()), 1e-30)
            assert err <= 1e-5 * scale, (kind, name, err, scale)


def test_train_step_remat_on_and_off(card):
    runs = []
    for remat in (False, True):
        state, step = _train_setup(card, remat=remat)
        state, metrics = step(state, _train_batch(card))
        bn = {k: v for k, v in state.model.state_dict().items()
              if "running" in k}
        runs.append((metrics, bn))
    (m0, bn0), (m1, bn1) = runs
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=1e-4, atol=1e-6)
    for k in bn0:
        scale = float(bn0[k].abs().max())
        assert float((bn1[k] - bn0[k]).abs().max()) <= 1e-5 * scale, k


def test_train_step_with_an_image_without_gts(card):
    """One image has no valid GT: finite losses, and the other image's
    positives still train (the avg_factor floor only guards 0/0)."""
    state, step = _train_setup(card)
    state, metrics = step(state, _train_batch(card, empty_image=0))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert float(metrics["loss_bbox"]) > 0
    state, step = _train_setup(card)
    batch = _train_batch(card, empty_image=0)
    batch["gt_valid"][:] = False
    state, metrics = step(state, batch)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert float(metrics["loss_bbox"]) == 0.0


# ---------------------------------------------------------------------------
# the YOLOX and GFL trainers, and B3 on the int8 GFL head


def _family_setup(device, family, dtype=torch.float64, seed=0, **step_kw):
    """A seeded small YOLOX-nano (64x96, yolox_sgd in its warmup) or
    GFLDet-18 (64 channels, 128x128, mp_sgd) train state in ``dtype``,
    biases and BN statistics jittered, and its step."""
    from glsdet_tpu_torch.models import GFLDet, YOLOXDetector
    from glsdet_tpu_torch.train import schedules
    from glsdet_tpu_torch.train.state import TrainState
    from glsdet_tpu_torch.train.steps import (make_gfl_train_step,
                                              make_yolox_train_step)

    gen = torch.Generator().manual_seed(seed)
    if family == "yolox":
        model = YOLOXDetector(10, "nano", generator=gen)
        opt = schedules.yolox_sgd(model.parameters(),
                                  schedules.yolox_warm_cos(0.01, 4, 20, 4))
    else:
        model = GFLDet(10, 18, 64, generator=gen)
        opt = schedules.mp_det_sgd(model.parameters(),
                                   schedules.schedule_1x(0.01, 100))
    _jitter_bn(model)
    model.to(device, dtype)
    state = TrainState.create(model, opt, torch.Generator(device=device))
    opt.count = 2                       # a non-zero learning rate
    if family == "yolox":
        step = make_yolox_train_step(model, (64, 96), normalize=True,
                                     **step_kw)
    else:
        step = make_gfl_train_step(model, (128, 128), 10, normalize=True)
    return state, step


def _family_batch(device, hw, b=2, g=4, seed=0):
    rs = np.random.RandomState(seed)
    x1 = rs.uniform(0, hw[1] - 32, (b, g))
    y1 = rs.uniform(0, hw[0] - 32, (b, g))
    wh = rs.uniform(6, 30, (b, g, 2))
    boxes = np.concatenate([np.stack([x1, y1], -1),
                            np.stack([x1, y1], -1) + wh], -1)
    valid = np.ones((b, g), bool)
    valid[:, -1] = False
    batch = {"images": rs.randint(0, 255, (b, *hw, 3)).astype(np.uint8),
             "gt_boxes": boxes.astype(np.float32),
             "gt_labels": rs.randint(0, 10, (b, g)).astype(np.int64),
             "gt_valid": valid}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@pytest.mark.parametrize("family,hw", [("yolox", (64, 96)),
                                       ("gfl", (128, 128))])
def test_family_train_step_on_the_card_matches_the_cpu(card, family, hw):
    """One float64 step of the same seeded state on the CPU and on the
    card (TF32 off): metrics within 1e-5 relative (num_fg equal); every
    parameter, BN statistic, EMA and momentum leaf within 1e-5 of its
    max (the losses are float32 on both devices)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for dev in (torch.device("cpu"), card):
            state, step = _family_setup(dev, family)
            state, metrics = step(state, _family_batch(dev, hw))
            named = dict(state.model.named_parameters())
            leaves = {"state": state.model.state_dict(),
                      "momentum": {n: state.optimizer.state[p][
                          "momentum_buffer"] for n, p in named.items()},
                      "ema": state.ema_params}
            runs.append((leaves, metrics))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (cl, cm), (gl, gm) = runs
    for k in cm:
        assert bool(torch.isfinite(cm[k])), k
        torch.testing.assert_close(gm[k].cpu(), cm[k], rtol=1e-5, atol=0)
    for kind, leaves in cl.items():
        for name, want in leaves.items():
            if name.endswith("num_batches_tracked"):
                continue
            want, got = want.double(), gl[kind][name].cpu().double()
            err = float((got - want).abs().max())
            scale = max(float(want.abs().max()), 1e-30)
            assert err <= 1e-5 * scale, (kind, name, err, scale)


@pytest.mark.parametrize("family,kw", [("yolox", {}),
                                       ("yolox", {"use_l1": True,
                                                  "resize_from": (96, 128)}),
                                       ("gfl", {})])
def test_family_train_step_does_not_sync_with_the_host(card, family, kw):
    """bf16 autocast as the configs train; one warm step, then one under
    the sync debug mode."""
    state, step = _family_setup(card, family, torch.float32, **kw)
    if family == "yolox":
        from glsdet_tpu_torch.train.steps import make_yolox_train_step
        step = make_yolox_train_step(state.model, (64, 96), normalize=True,
                                     dtype=torch.bfloat16, **kw)
        hw = kw.get("resize_from", (64, 96))
    else:
        from glsdet_tpu_torch.train.steps import make_gfl_train_step
        step = make_gfl_train_step(state.model, (128, 128), 10,
                                   normalize=True, dtype=torch.bfloat16)
        hw = (128, 128)
    batch = _family_batch(card, hw)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def test_resize_bilinear_on_the_card_equals_the_cpu(card):
    from glsdet_tpu_torch.ops.image import resize_bilinear

    x = torch.rand(2, 96, 80, 3, generator=torch.Generator().manual_seed(1))
    for hw in ((64, 112), (128, 48)):
        got = resize_bilinear(x.to(card), hw).cpu()
        torch.testing.assert_close(got, resize_bilinear(x, hw), rtol=0,
                                   atol=1e-5)


def test_gn_kernel_on_the_int8_gfl_towers(card):
    """A GFLHead at 256 channels on five levels (32^2 down to 2^2, batch
    2), calibrated and quantized on the card in bf16: B3 launches 8 times
    per level, and on the accumulators the towers give it, each launch
    within +-1 code of its plain version (at most 1e-3 differing)."""
    from glsdet_tpu_torch.models.gfl_head import GFLHead
    from glsdet_tpu_torch.ops import quant_static as tq

    head = GFLHead(10, 256)
    flax_init_(head, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    feats = [torch.randn(2, 256, s, s, generator=g).to(card, torch.bfloat16)
             for s in (32, 16, 8, 4, 2)]
    scales = tq.calibrate_scales(head.to(card, torch.bfloat16).eval(),
                                 [feats])
    q = tq.quantize_static(head.float(), scales, dtype=torch.bfloat16,
                           device=card)
    assert type(q) is tq.Int8GFLHead
    calls = []
    real = gn_kernel.gn_relu_quant_acc

    def spy(acc, deq, gamma, beta, s_out, **kw):
        out = real(acc, deq, gamma, beta, s_out, **kw)
        calls.append((acc.clone(), deq, gamma, beta, s_out, kw, out))
        return out

    tq.gn_relu_quant_acc = spy
    try:
        before = gn_kernel.launches
        with torch.inference_mode():
            cls, reg = q(feats)
        torch.cuda.synchronize()
        launched = gn_kernel.launches - before
    finally:
        tq.gn_relu_quant_acc = real
    assert launched == len(calls) == 40
    for acc, deq, gamma, beta, s_out, kw, out in calls:
        want = gn_kernel.gn_relu_quant_acc_plain(
            acc, deq, gamma, beta, s_out, kw["groups"], kw["eps"],
            kw["dtype"])
        d = (out.int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    assert all(bool(torch.isfinite(t).all()) for t in cls + reg)


def _color_batch(b=3, hw=(40, 56), seed=0):
    rs = np.random.RandomState(seed)
    return {
        "images": torch.from_numpy(rs.randint(0, 256, (b, *hw, 3),
                                              dtype=np.uint8)),
        "mix_images": torch.from_numpy(rs.randint(0, 256, (b, *hw, 3),
                                                  dtype=np.uint8)),
        "mix_weight": torch.tensor([1.0, 0.5, 0.5][:b]),
        "hsv_deltas": torch.from_numpy(np.stack([
            rs.randint(-5, 6, b), rs.randint(-30, 31, b),
            rs.randint(-30, 31, b)], 1).astype(np.float32)),
    }


def test_device_color_on_the_card_matches_the_cpu(card):
    from glsdet_tpu_torch.data import device_color as dc

    batch = _color_batch()
    want = dc.apply_batch_color(batch)
    got = dc.apply_batch_color({k: v.to(card) for k, v in batch.items()})
    diff = (got.cpu() - want).abs()
    assert diff.max() <= 1, float((diff > 0).float().mean())
    codes = torch.rand(4096, 3, generator=torch.Generator().manual_seed(2))
    codes = torch.round(codes * 255)
    hsv = dc.rgb_to_hsv_u8(codes)
    d = (dc.rgb_to_hsv_u8(codes.to(card)).cpu() - hsv).abs()
    assert d.max() <= 1, float((d > 0).float().mean())
    d = (dc.hsv_to_rgb_u8(hsv.to(card)).cpu() - dc.hsv_to_rgb_u8(hsv)).abs()
    assert d.max() <= 1, float((d > 0).float().mean())


def test_geom_warp_on_the_card_matches_the_cpu(card):
    from glsdet_tpu_torch.data import augment as aug
    from glsdet_tpu_torch.data import device_geom as dg

    rs = np.random.RandomState(3)
    shapes = [(30, 50), (40, 36), (28, 28), (50, 60)]
    srcs = np.zeros((2, 4, 50, 60, 3), np.uint8)
    quads, mats = [], []
    for k in range(2):
        for i, (h, w) in enumerate(shapes):
            srcs[k, i, :h, :w] = rs.randint(0, 256, (h, w, 3))
        _, _, q = aug.mosaic4_params(shapes, (32, 48), rs)
        quads.append(dg.quads_to_array(q, shapes))
        mats.append(dg.inverse_affine_2x3(
            aug.random_affine_params(rs, (64, 96), (32, 48))))
    args = [torch.from_numpy(np.stack(a)) for a in (srcs, quads, mats)]
    want = dg.geom_warp(*args, (32, 48))
    got = dg.geom_warp(*(a.to(card) for a in args), (32, 48)).cpu()
    diff = (got - want).abs()
    assert diff.max() <= 1, float((diff > 0).float().mean())


def test_image_warp_and_resize_on_the_card_equal_the_cpu(card):
    from glsdet_tpu_torch.data.augment import random_affine_params
    from glsdet_tpu_torch.ops.image import resize_linear_u8, warp_affine_u8

    rs = np.random.RandomState(4)
    img = torch.from_numpy(rs.randint(0, 256, (150, 190, 3), dtype=np.uint8))
    for _ in range(4):
        mat = random_affine_params(rs, (150, 190), (75, 90))[:2]
        assert torch.equal(warp_affine_u8(img.to(card), mat, (75, 90)).cpu(),
                           warp_affine_u8(img, mat, (75, 90)))
    for hw in ((71, 95), (300, 380), (75, 95)):
        assert torch.equal(resize_linear_u8(img.to(card), hw).cpu(),
                           resize_linear_u8(img, hw))


def test_train_from_png_files_makes_no_host_sync_between_reads(card,
                                                               tmp_path):
    """Three steps of ``train()`` (YOLOX-nano, 128x128, device colour)
    from PNG files, with the sync debug mode at "error" from the first
    batch on; no step reaches the loop's own reads (every 10 steps, the
    log interval) or a checkpoint."""
    import json

    from glsdet_tpu_torch.config import apply_overrides, get_config
    from glsdet_tpu_torch.data.image_io import write_png
    from glsdet_tpu_torch.train import loop

    rs = np.random.RandomState(0)
    os.makedirs(tmp_path / "img")
    images, anns = [], []
    for i in range(8):
        write_png(str(tmp_path / "img" / f"{i}.png"),
                  rs.randint(0, 256, (90, 160, 3), dtype=np.uint8))
        images.append({"id": i + 1, "file_name": f"{i}.png", "width": 160,
                       "height": 90})
        anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1,
                     "bbox": [20.0, 10.0, 30.0, 25.0], "iscrowd": 0})
    with open(tmp_path / "ann.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 0, "name": "a"},
                                  {"id": 1, "name": "b"}]}, f)
    cfg = apply_overrides(get_config("coarse_det"), {
        "model.phi": "nano", "data.img_hw": (128, 128), "data.batch_size": 2,
        "data.num_workers": 0, "data.ann_file": str(tmp_path / "ann.json"),
        "data.img_root": str(tmp_path / "img"),
        "train.work_dir": str(tmp_path / "work"), "train.log_interval": 100,
        "train.ckpt_interval": 100})
    real_loader = loop.train_loader
    steps = []

    def checked_loader(*args, **kw):
        inner = real_loader(*args, **kw)
        try:
            for batch in inner:
                torch.cuda.set_sync_debug_mode("error")
                steps.append(batch["images"].is_pinned())
                yield batch
        finally:
            torch.cuda.set_sync_debug_mode(0)
            inner.close()

    loop.train_loader = checked_loader
    try:
        state = loop.train(cfg, max_steps=3, device="cuda")
    finally:
        loop.train_loader = real_loader
        torch.cuda.set_sync_debug_mode(0)
    assert state.step == 3 and steps == [True] * 3
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())


# (B, K, offset, threshold) of the eval path's NMS launches: run_eval of
# coarse_det (batch 8, budget 4 * 100), of mp_det_res50 (batch 4,
# max_dets 500: budget 2000, 0.6), run_eval_tta's per-variant forward and
# union (batch 1, <= 4 x 100 rows), and tta_detect's union at its own
# defaults with 4 scales and flip (8 x 300 = 2400 rows)
EVAL_NMS_SHAPES = [(8, 400, 0.0, 0.65), (4, 2000, 0.0, 0.6),
                   (1, 400, 0.0, 0.65), (1, 2400, 0.0, 0.65)]


@pytest.mark.parametrize("b,k,offset,thr", EVAL_NMS_SHAPES)
def test_nms_kernel_at_the_eval_shapes(card, b, k, offset, thr):
    rs = np.random.RandomState(k + b)
    boxes = _det_boxes(rs, b, k, extent=1360.0)
    labels = rs.randint(0, 10, (b, k))
    boxes = torch.from_numpy((boxes + labels[..., None] * 8192.0)
                             .astype(np.float32)).to(card)
    valid = torch.from_numpy(rs.rand(b, k) > 0.1).to(card)
    got = nms_kernel.nms_sorted_cuda(boxes, valid, thr, offset)
    want = tnms.nms_sorted_plain(boxes, valid, thr, offset)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _eval_png_set(root, n=6):
    """``n`` PNG frames of two sizes with a few boxes each, and their COCO
    json (category ids 1, 3, ...)."""
    import json

    from glsdet_tpu_torch.data.image_io import write_png

    rs = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "img"))
    images, anns = [], []
    for i in range(n):
        h, w = ((90, 160), (120, 96))[i % 2]
        img = np.kron(rs.randint(40, 216, (h // 8 + 1, w // 8 + 1, 3)),
                      np.ones((8, 8, 1)))[:h, :w].astype(np.uint8)
        write_png(os.path.join(root, "img", f"{i}.png"), img)
        images.append({"id": i + 1, "file_name": f"{i}.png", "width": w,
                       "height": h})
        for _ in range(4):
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": 2 * int(rs.randint(0, 10)) + 1,
                         "bbox": [float(rs.uniform(0, w - 30)),
                                  float(rs.uniform(0, h - 30)), 24.0, 20.0],
                         "iscrowd": 0})
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 2 * c + 1, "name": f"c{c}"}
                                  for c in range(10)]}, f)
    return ann, os.path.join(root, "img")


def test_run_eval_on_the_card_equals_the_cpu(card, tmp_path):
    """run_eval of a float32 YOLOX-nano at 64x64 (TF32 off) over the same
    PNG set on the card and on the CPU: the same number of detections per
    image, boxes within 1e-3, scores within 1e-5, the COCO stats within
    1e-3; B2 launched once per batch on the card."""
    import copy

    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.eval import runner
    from glsdet_tpu_torch.models import YOLOXDetector

    ann, img_root = _eval_png_set(str(tmp_path))
    cpu = YOLOXDetector(10, "nano",
                        generator=torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():        # spread the scores off the prior
        for name, p in cpu.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    gpu = copy.deepcopy(cpu).to(card)
    dumps = {}
    kw = dict(batch_size=4, score_thr=0.01, max_dets=100, verbose=False)
    results = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        out = str(tmp_path / f"{dev}.json")
        before = nms_kernel.launches
        results[dev], _ = runner.run_eval(CocoDataset(ann, img_root), model,
                                          "yolox", (64, 64), 10, device=dev,
                                          out_json=out, **kw)
        if dev == "cuda":
            assert nms_kernel.launches == before + 2
        with open(out) as f:
            dumps[dev] = json.load(f)
    assert len(dumps["cpu"]) == len(dumps["cuda"]) > 0
    for a, b in zip(sorted(dumps["cpu"], key=lambda d: (d["image_id"],
                                                        -d["score"])),
                    sorted(dumps["cuda"], key=lambda d: (d["image_id"],
                                                         -d["score"]))):
        assert a["image_id"] == b["image_id"]
        assert abs(a["score"] - b["score"]) <= 1e-5
    np.testing.assert_allclose(results["cuda"].stats, results["cpu"].stats,
                               atol=1e-3)


def test_tta_detect_union_above_2048_on_the_card(card):
    """tta_detect's defaults with 4 scales and flip put 2400 rows into one
    NMS: on the card it runs the kernel once and keeps what the CPU
    keeps."""
    from glsdet_tpu_torch.eval.tta import tta_detect

    def detect(img):
        h, w = img.shape[:2]
        rs = np.random.RandomState(
            int((img[..., 0].astype(np.int64) * np.arange(w)).sum())
            % 2 ** 31)
        xy = rs.uniform(0, 1, (300, 2)) * [w * 0.8, h * 0.8]
        wh = rs.uniform(0.05, 0.2, (300, 2)) * [w, h]
        return {"boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
                "scores": rs.rand(300).astype(np.float32),
                "labels": rs.randint(0, 4, 300)}

    img = np.random.RandomState(2).randint(0, 256, (90, 150, 3), np.uint8)
    scales = (0.5, 0.75, 1.0, 1.5)
    before = nms_kernel.launches
    got = tta_detect(detect, img, scales=scales, device="cuda")
    assert nms_kernel.launches == before + 1
    assert nms_kernel.shapes[-1][:2] == (1, 2400)
    want = tta_detect(detect, img, scales=scales, device="cpu")
    for key in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(got[key], want[key])


def test_run_eval_on_jpeg_frames_equals_png_of_their_pixels(card, tmp_path):
    """run_eval of YOLOX-nano at 64x64 on the card over JPEG frames
    (encode_jpeg of the PNG set's frames) and over PNGs of the pixels the
    port decodes from them: the same detections; B2 launched once per
    batch in each."""
    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.data.image_io import (read_image, write_jpeg,
                                                write_png)
    from glsdet_tpu_torch.eval import runner
    from glsdet_tpu_torch.models import YOLOXDetector

    ann, img_root = _eval_png_set(str(tmp_path))
    with open(ann) as f:
        coco = json.load(f)
    roots = {"jpeg": str(tmp_path / "jpg"), "png": str(tmp_path / "png")}
    for d in roots.values():
        os.makedirs(d)
    for im in coco["images"]:
        stem = os.path.splitext(im["file_name"])[0]
        jpg = os.path.join(roots["jpeg"], stem + ".jpg")
        write_jpeg(jpg, read_image(os.path.join(img_root, im["file_name"])))
        write_png(os.path.join(roots["png"], stem + ".png"), read_image(jpg))
    model = YOLOXDetector(10, "nano",
                          generator=torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():        # spread the scores off the prior
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    model = model.to(card)
    dumps = {}
    for kind, ext in (("jpeg", ".jpg"), ("png", ".png")):
        split = str(tmp_path / f"{kind}.json")
        with open(split, "w") as f:
            json.dump(dict(coco, images=[
                dict(im, file_name=os.path.splitext(im["file_name"])[0]
                     + ext) for im in coco["images"]]), f)
        out = str(tmp_path / f"{kind}_dets.json")
        before = nms_kernel.launches
        runner.run_eval(CocoDataset(split, roots[kind]), model, "yolox",
                        (64, 64), 10, batch_size=4, score_thr=0.01,
                        max_dets=100, verbose=False, device="cuda",
                        out_json=out)
        assert nms_kernel.launches == before + 2
        with open(out) as f:
            dumps[kind] = json.load(f)
    assert len(dumps["jpeg"]) > 0 and dumps["jpeg"] == dumps["png"]


def test_imported_weights_serve_the_same_detections_on_the_card(card,
                                                                tmp_path):
    """TwoStageDetector on the card from reference-named checkpoints
    converted by tools/import_torch_weights.py gives the detections of
    one from the port's own state-dict files (YOLOX-nano, MP-Det-18)."""
    import sys

    from glsdet_tpu_torch.apis import TwoStageDetector
    from glsdet_tpu_torch.config import apply_overrides, get_config
    from glsdet_tpu_torch.models.build import build_model
    from glsdet_tpu_torch.tools import import_torch_weights

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    coarse_opts = {"model.phi": "nano", "data.img_hw": (64, 64),
                   "eval.coarse_score_thr": 1e-4,
                   "eval.mosaic_buckets": (128, 256)}
    mp_opts = {"model.depth": 18}
    own, conv = [], []
    for name, family, opts, shape_opts in (
            ("coarse_det", "yolox", coarse_opts, ["model.phi=nano"]),
            ("mp_det_res50", "mpdet", mp_opts, ["model.depth=18"])):
        model = build_model(apply_overrides(get_config(name), opts),
                            device="cpu")
        path = str(tmp_path / f"{name}.pt")
        torch.save(model.state_dict(), path)
        src = str(tmp_path / f"{name}.pth")
        torch.save(chip_smoke.reference_checkpoint(model.state_dict(),
                                                   family), src)
        dst = str(tmp_path / f"{name}_imported.pt")
        import_torch_weights.main([src, dst, "--arch", family, "--config",
                                   name, "--cfg-options", *shape_opts])
        own.append(path)
        conv.append(dst)
    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 255, (64, 96, 3), np.uint8) for _ in range(3)]
    dets = []
    for paths in (own, conv):
        det = TwoStageDetector("coarse_det", paths[0], "mp_det_res50",
                               paths[1], coarse_options=coarse_opts,
                               mp_options=mp_opts, device="cuda")
        try:
            dets.append(det.detect_batch(frames))
        finally:
            det.close()
    for a, b in zip(*dets):
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
