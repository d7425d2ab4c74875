"""Device-side geometric stage: the fused mosaic + random-affine
gather-warp, the counterpart of ``glsdet_tpu.data.device_geom``.

The host path paints a 2x canvas (four resizes) and warps it down
(``data/augment.py: mosaic4`` + ``random_affine``).  With
``TrainPipeline(device_geom=True)`` the host samples the same parameters
(``mosaic4_params`` / ``random_affine_params``, the same ``RandomState``
draws) and does the exact box geometry, and the train step renders the
pixels here in one gather: each output pixel maps through the inverse
affine into the virtual 2x canvas, picks its mosaic quadrant, and
bilinear-samples that quadrant's raw source image.

Numerics against the host path: boxes bit-exact (the same numpy code);
pixels differ where the single bilinear replaces the host's
resize-then-warp double resample (``tests/test_device_geom.py`` holds
the JAX package's envelope).  Against the JAX function this is the same
float32 arithmetic in the same order (``tests/test_torch_augment.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

PAD_VAL = 114.0

# quads row layout (per mosaic quadrant, float32):
#   0:x1 1:y1 2:x2 3:y2   placement rect on the 2x canvas
#   4:sx1 5:sy1           crop offset into the resized image
#   6:rxr 7:ryr           resized->source ratios (w0/nw, h0/nh)
#   8:w0 9:h0             valid source size inside the padded array
QUAD_COLS = 10


def quads_to_array(quads: Sequence[Tuple], shapes: Sequence[Tuple[int, int]]
                   ) -> np.ndarray:
    """mosaic4_params quads + source shapes -> the (4, 10) device rows."""
    out = np.zeros((4, QUAD_COLS), np.float32)
    for i, ((x1, y1, x2, y2, sx1, sy1, _scale, nw, nh),
            (h0, w0)) in enumerate(zip(quads, shapes)):
        out[i] = (x1, y1, x2, y2, sx1, sy1,
                  w0 / max(nw, 1), h0 / max(nh, 1), w0, h0)
    return out


def flip_affine(mat: np.ndarray, out_w: int) -> np.ndarray:
    """Fold a horizontal flip of the OUTPUT into the affine (3x3,
    canvas -> out): flipped(x, y) = original(W - 1 - x, y)."""
    f = np.array([[-1.0, 0.0, out_w - 1.0],
                  [0.0, 1.0, 0.0],
                  [0.0, 0.0, 1.0]], np.float64)
    return f @ mat


def inverse_affine_2x3(mat: np.ndarray) -> np.ndarray:
    """(3, 3) canvas->out affine -> (2, 3) out->canvas inverse rows."""
    return np.linalg.inv(mat)[:2].astype(np.float32)


def geom_warp(sources: torch.Tensor, quads: torch.Tensor, mats: torch.Tensor,
              out_hw: Tuple[int, int], pad_val: float = PAD_VAL
              ) -> torch.Tensor:
    """The fused mosaic + affine warp, on the sources' device.

    sources: (B, 4, HS, WS, 3) uint8 padded raw images
    quads:   (B, 4, 10) float32 (see QUAD_COLS layout)
    mats:    (B, 2, 3) float32 INVERSE affine (output pixel -> canvas)
    Returns (B, HO, WO, 3) float32 uint8-codes."""
    ho, wo = out_hw
    b, _, hs, ws, ch = sources.shape
    dev = sources.device
    ys, xs = torch.meshgrid(torch.arange(ho, dtype=torch.float32, device=dev),
                            torch.arange(wo, dtype=torch.float32, device=dev),
                            indexing="ij")

    def col(t, *idx):
        return t[(slice(None), *idx)][:, None, None]

    u = col(mats, 0, 0) * xs + col(mats, 0, 1) * ys + col(mats, 0, 2)
    v = col(mats, 1, 0) * xs + col(mats, 1, 1) * ys + col(mats, 1, 2)
    flat = sources.reshape(b, 4 * hs * ws, ch)
    out = torch.full((b, ho, wo, ch), pad_val, dtype=torch.float32,
                     device=dev)
    for q in range(4):
        x1, y1, x2, y2, sx1, sy1, rxr, ryr, w0, h0 = (
            col(quads, q, i) for i in range(QUAD_COLS))
        in_q = (u >= x1) & (u < x2) & (v >= y1) & (v < y2)
        # continuous canvas -> resized-image -> source coords
        # (cv2.resize INTER_LINEAR pixel-center mapping)
        sx = (u - x1 + sx1 + 0.5) * rxr - 0.5
        sy = (v - y1 + sy1 + 0.5) * ryr - 0.5
        x0 = torch.floor(sx)
        y0 = torch.floor(sy)
        wx = (sx - x0)[..., None]
        wy = (sy - y0)[..., None]

        def tap(yi, xi):
            # cv2.resize clamps taps at the source border
            yc = torch.minimum(torch.clamp(yi, min=0.0), h0 - 1.0).to(
                torch.int64)
            xc = torch.minimum(torch.clamp(xi, min=0.0), w0 - 1.0).to(
                torch.int64)
            lin = (q * (hs * ws) + yc * ws + xc).reshape(b, -1, 1)
            return torch.gather(flat, 1, lin.expand(-1, -1, ch)).reshape(
                b, ho, wo, ch).float()

        val = ((tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx) * (1 - wy)
               + (tap(y0 + 1, x0) * (1 - wx)
                  + tap(y0 + 1, x0 + 1) * wx) * wy)
        out = torch.where(in_q[..., None], val, out)
    return out
