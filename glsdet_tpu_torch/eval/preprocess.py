"""The two preprocessing chains of the serving path, as plain functions.

- :func:`coarse_inputs`: uint8 frames -> the coarse model's normalized
  input (antialiased bilinear resize, then ``(x - mean) * inv_std``).
- :func:`mosaic_inputs_plain`: uint8 frames + region rows -> MP-Det's
  normalized mosaic input, as the JAX package computes it: paint at the
  tile-aligned ``paint_hw_for(hw)``, crop to ``hw``, normalize.  It is
  the plain version of the painter's path entry
  (``ufp/paint_kernel.py: paint_mosaic_inputs_cuda``), which paints at
  ``hw`` directly and normalizes in the same pass.

Both normalize in ``dtype`` with the mean and inverse standard deviation
rounded to ``dtype`` first, each op rounding once, as the JAX package's
``mosaic_dtype`` chains do (``glsdet_tpu/eval/two_stage.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from glsdet_tpu_torch.ufp.paint_kernel import assemble_mosaic_plain_batch

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)

_consts: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def norm_constants(dtype: torch.dtype, device) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """(mean, inv_std), each (3,) in ``dtype`` on ``device``: float32
    values rounded to ``dtype``, as the JAX package's
    ``mean.astype(dt)``.  Made once per (dtype, device) and kept, so a
    later call copies nothing to the card."""
    key = (dtype, torch.device(device))
    if key not in _consts:
        mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32)
        inv_std = 1.0 / torch.tensor(PIXEL_STD, dtype=torch.float32)
        _consts[key] = (mean.to(key[1], dtype), inv_std.to(key[1], dtype))
    return _consts[key]


def paint_tile(out_hw: int) -> int:
    """The JAX painter's tile size for a canvas bucket."""
    return min(256, out_hw) // 4 * 4


def paint_hw_for(hw: int) -> int:
    """The JAX package's painting canvas for model bucket ``hw``: the next
    ``paint_tile`` multiple, cropped back to ``hw`` before MP-Det.  Only
    :func:`mosaic_inputs_plain` paints there; the CUDA painter needs no
    alignment and paints at ``hw``."""
    t = paint_tile(hw)
    return -(-hw // t) * t


def coarse_inputs(imgs: torch.Tensor, coarse_hw: Tuple[int, int],
                  dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames -> (B, 3, h, w) normalized ``dtype``
    input (NCHW view of channels-last memory).  The antialiased bilinear
    resize (``jax.image.resize`` when it downsamples) runs in float32 and
    is rounded to ``dtype`` once before the normalize: the JAX package
    resizes in ``dtype`` (ROADMAP §C says why the port keeps float32)."""
    x = F.interpolate(imgs.permute(0, 3, 1, 2).float(),
                      size=tuple(coarse_hw), mode="bilinear",
                      antialias=True, align_corners=False)
    mean, inv_std = norm_constants(dtype, imgs.device)
    return (x.to(dtype) - mean[:, None, None]) * inv_std[:, None, None]


def mosaic_inputs_plain(images: torch.Tensor, idx: torch.Tensor,
                        rows: torch.Tensor, hw: int, dtype: torch.dtype,
                        mean: torch.Tensor = None,
                        inv_std: torch.Tensor = None) -> torch.Tensor:
    """(b, hw, hw, 3) normalized mosaics in ``dtype``: the canvas painted
    at ``paint_hw_for(hw)`` in ``dtype``, cropped to ``hw``, then
    ``(canvas - mean) * inv_std`` (by default :func:`norm_constants`).
    Arguments as ``assemble_mosaic_plain_batch``."""
    if mean is None or inv_std is None:
        mean, inv_std = norm_constants(dtype, images.device)
    ph = paint_hw_for(hw)
    canvas = assemble_mosaic_plain_batch(images, idx, rows, ph, ph,
                                         dtype)[:, :hw, :hw]
    return (canvas - mean) * inv_std
