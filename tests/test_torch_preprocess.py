"""Port parity: the two preprocessing chains at serving precision.

The JAX pipeline built with ``mosaic_dtype=jnp.bfloat16`` (its default)
against the port's plain chains in bfloat16, on the CPU:

- the canvas chain, ``eval/preprocess.py: mosaic_inputs_plain`` against
  ``JPipeline._mosaic_inputs_j`` with ``painter="pallas"`` (interpret
  mode here), as tests/test_two_stage.py calls it: a bucket that crops
  (384 paints at 512) and one that does not (256), factors {1, 2, 4},
  chips across the 256 tiles, over the frame's corner and over the
  canvas.  Bit-equal: the painted value is exact in float32 and each of
  the three bf16 steps (cast, subtract, multiply) rounds once in both.
- the coarse chain, ``coarse_inputs(..., torch.bfloat16)`` (float32
  antialiased resize, rounded to bf16 once, as the card runs it) against
  ``JPipeline._coarse_inputs_j`` (the resize in bf16), on noise frames at
  765x1360 -> 640^2 and 96x160 -> 64^2.  Not equal: the bounds below are
  the measured differences, in bf16 ulps of the normalized value (at the
  larger magnitude of the two) and in ulps of the resized pixel (one
  bf16 ulp of the resize's output, times inv_std: the rounding the chain
  makes first).  The port's chain is the nearer of the two to the exact
  float32 chain, which is why the port keeps it (ROADMAP §C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from glsdet_tpu.eval.two_stage import TwoStagePipeline as JPipeline
from glsdet_tpu_torch.eval.preprocess import (PIXEL_STD, coarse_inputs,
                                              mosaic_inputs_plain,
                                              norm_constants, paint_hw_for)
from glsdet_tpu_torch.ufp import paint_kernel as tpk


def _jpipe(coarse_hw):
    """The JAX pipeline's preprocessing programs; its models never run."""
    return JPipeline(lambda im: None, lambda im: None, coarse_hw,
                     mosaic_dtype=jnp.bfloat16, painter="pallas",
                     pack_threads=1)


def _frames(n, h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3),
                                               np.uint8)


# [x1, y1, w, h, nx, ny, f] per slot: one chip per factor, chips across
# the 256 tile boundaries, one at the frame's corner, chips over the 256
# and 384 canvases' right and bottom edges, and overlaps (the last wins)
ROWS = np.zeros((2, 8, 7), np.float32)
ROWS[0, :6] = [[0, 0, 70, 45, 30, 40, 1],
               [30, 40, 25, 15, 240, 5, 2],
               [55, 45, 10, 10, 250, 250, 4],
               [100, 100, 60, 50, 350, 300, 2],
               [150, 40, 60, 50, 210, 170, 1],
               [250, 150, 70, 50, 60, 60, 1]]
ROWS[1, :5] = [[10, 20, 50, 40, 5, 7, 1],
               [10, 20, 30, 20, 233, 17, 2],
               [3, 4, 12, 10, 200, 240, 4],
               [40, 5, 30, 30, 300, 370, 1],
               [200, 150, 100, 45, 150, 100, 2]]
IDX = np.array([1, 0], np.int64)


def _canvas_inputs():
    return (torch.from_numpy(_frames(2, 200, 320, 0)),
            torch.from_numpy(IDX.copy()), torch.from_numpy(ROWS.copy()))


@pytest.fixture(scope="module")
def jpipe():
    return _jpipe((64, 64))


@pytest.mark.parametrize("hw", [384, 256])
def test_canvas_chain_bit_equal_to_jax_bf16(jpipe, hw):
    frames, idx, rows = _canvas_inputs()
    want = np.asarray(jpipe._mosaic_inputs_j(
        jnp.asarray(frames.numpy()), jnp.asarray(IDX.astype(np.int32)),
        jnp.asarray(ROWS.copy()), hw)).astype(np.float32)
    got = mosaic_inputs_plain(frames, idx, rows, hw, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, hw, hw, 3)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("hw", [384, 256, 100])
def test_painting_at_hw_equals_the_cropped_aligned_canvas(hw):
    """What lets the path entry paint at hw: every pixel is painted on its
    own, so the canvas at hw is the crop of the canvas at
    paint_hw_for(hw)."""
    frames, idx, rows = _canvas_inputs()
    ph = paint_hw_for(hw)
    for dt in (torch.float32, torch.bfloat16):
        full = tpk.assemble_mosaic_plain_batch(frames, idx, rows, ph, ph, dt)
        at_hw = tpk.assemble_mosaic_plain_batch(frames, idx, rows, hw, hw,
                                                dt)
        assert torch.equal(at_hw, full[:, :hw, :hw])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_path_entry_on_the_cpu_is_the_plain_chain(dtype):
    frames, idx, rows = _canvas_inputs()
    mean, inv_std = norm_constants(dtype, "cpu")
    got = tpk.paint_mosaic_inputs_cuda(frames, idx, rows, 384, mean,
                                       inv_std)
    want = mosaic_inputs_plain(frames, idx, rows, 384, dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    # no row covers the bottom-right corner of slot 1: the normalized 0
    zero = ((torch.zeros(3, dtype=dtype) - mean) * inv_std)
    assert torch.equal(got[1, -1, -1], zero)


def _ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


# (frame, coarse input): max and share beyond 1 ulp of |port - JAX| in
# ulps of the normalized value; the same in ulps of the resized pixel;
# measured on these seeded frames (CPU, XLA and PyTorch as pinned here)
COARSE_CASES = {((765, 1360), (640, 640)): (286.0, 0.332, 7.3, 0.179),
                ((96, 160), (64, 64)): (143.0, 0.229, 2.01, 0.128)}


@pytest.mark.parametrize("frame_hw,coarse_hw", list(COARSE_CASES))
def test_coarse_chain_against_jax_bf16(frame_hw, coarse_hw):
    stack = _frames(2, *frame_hw, 1)
    want = np.asarray(_jpipe(coarse_hw)._coarse_inputs_j(
        jnp.asarray(stack.copy()))).astype(np.float32)
    frames = torch.from_numpy(stack.copy())
    got = coarse_inputs(frames, coarse_hw, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    exact = coarse_inputs(frames, coarse_hw,
                          torch.float32).permute(0, 2, 3, 1).numpy()
    resized = F.interpolate(frames.permute(0, 3, 1, 2).float(),
                            size=coarse_hw, mode="bilinear", antialias=True,
                            align_corners=False).permute(0, 2, 3, 1).numpy()
    pixel_ulp = _ulp(np.maximum(resized, 1.0)) / np.float32(PIXEL_STD)
    d = np.abs(got - want)
    in_norm = d / _ulp(np.maximum(np.abs(got), np.abs(want)))
    in_pixel = d / pixel_ulp
    max_norm, share_norm, max_pixel, share_pixel = COARSE_CASES[
        (frame_hw, coarse_hw)]
    assert in_norm.max() <= max_norm
    assert (in_norm > 1).mean() <= share_norm
    assert in_pixel.max() <= max_pixel
    assert (in_pixel > 1).mean() <= share_pixel
    # the port's chain is the nearer to the exact float32 chain
    port_off = (np.abs(got - exact) / pixel_ulp > 1).mean()
    jax_off = (np.abs(want - exact) / pixel_ulp > 1).mean()
    assert port_off < jax_off
