"""Device-side color augmentation: mixup blend + HSV jitter + normalize,
the counterpart of ``glsdet_tpu.data.device_color``.

Behavioral references:
- MixUp pixel blend: ``yolox-ufp/mmdet/datasets/pipelines/transforms.py``
  (:2216, ratio fixed ~0.5 in the YOLOX recipe); the host analog is
  ``data/augment.py: mixup`` (float blend, truncating uint8 cast).
- YOLOXHSVRandomAug: ``transforms.py:2698``, integer HSV deltas (h mod
  180, s/v clipped) around OpenCV's uint8 RGB <-> HSV conversion.

The host pipeline samples the parameters and does the exact box
geometry; the train step renders the pixels here, on the card, from the
batch keys the pipeline emits (``data/loader.py: TrainPipeline`` with
``device_color``): ``mix_images`` / ``mix_weight``, ``hsv_deltas`` and,
with ``device_geom``, ``geom_sources`` / ``geom_quads`` / ``geom_mat``
(``data/device_geom.py``).  Which keys a batch carries says which stages
run.

Numerics are the JAX package's: OpenCV's formulas in float32 with
round-half-even, within +-1 code of OpenCV's uint8 conversions and +-2
after a round trip; ``tests/test_torch_augment.py`` holds these
functions to the JAX package's, run eagerly.  Every function works on
tensors of any leading shape and on any device, and makes no host sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from glsdet_tpu_torch.data.coco import IMAGENET_MEAN, IMAGENET_STD


def imagenet_stats(device) -> tuple:
    """(mean, std) float32 tensors on ``device``, to make once and pass
    to :func:`normalize_images` (a host-to-device copy waits for the
    card)."""
    return (torch.from_numpy(IMAGENET_MEAN).to(device),
            torch.from_numpy(IMAGENET_STD).to(device))


def rgb_to_hsv_u8(rgb: torch.Tensor) -> torch.Tensor:
    """cv2 COLOR_RGB2HSV semantics for uint8 input (H in [0,180)).

    ``rgb``: (..., 3) float32 holding integer codes in [0, 255].
    Returns (..., 3) float32 integer codes (h, s, v)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    s = torch.where(v > 0,
                    torch.round(255.0 * diff / torch.clamp(v, min=1e-6)),
                    0.0)
    safe = torch.clamp(diff, min=1e-6)
    # 60deg per sector, stored as deg/2 -> 30/diff per code unit
    h = torch.where(
        v == r, 30.0 * (g - b) / safe,
        torch.where(v == g, 60.0 + 30.0 * (b - r) / safe,
                    120.0 + 30.0 * (r - g) / safe))
    h = torch.round(torch.where(diff > 0, h, 0.0))
    h = torch.where(h < 0, h + 180.0, h)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb_u8(hsv: torch.Tensor) -> torch.Tensor:
    """cv2 COLOR_HSV2RGB semantics for uint8 HSV codes -> uint8 RGB codes
    (float32 carriers)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    hd = h * 2.0                       # degrees
    # divide by tensors: on CUDA a division by a Python scalar becomes a
    # multiplication by its reciprocal, which rounds differently
    sf = s / hsv.new_full((), 255.0)
    sixty = hsv.new_full((), 60.0)
    sector = torch.floor(hd / sixty)
    f = hd / sixty - sector
    p = v * (1.0 - sf)
    q = v * (1.0 - sf * f)
    t = v * (1.0 - sf * (1.0 - f))
    sector = sector.to(torch.int64) % 6

    def select(*by_sector):
        out = by_sector[5]
        for k in range(4, -1, -1):
            out = torch.where(sector == k, by_sector[k], out)
        return out

    r = select(v, q, p, p, t, v)
    g = select(t, v, v, q, p, p)
    b = select(p, p, t, v, v, q)
    return torch.round(torch.stack([r, g, b], dim=-1))


def hsv_jitter(img: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """YOLOXHSVRandomAug on the device: ``img`` (..., 3) f32 uint8-codes,
    ``deltas`` (..., 3) (dh, ds, dv) broadcast over the spatial dims.  h
    wraps mod 180; s, v clip to [0, 255]."""
    hsv = rgb_to_hsv_u8(img)
    dh, ds, dv = deltas[..., 0], deltas[..., 1], deltas[..., 2]
    h = torch.remainder(hsv[..., 0] + dh, 180.0)
    s = torch.clamp(hsv[..., 1] + ds, 0.0, 255.0)
    v = torch.clamp(hsv[..., 2] + dv, 0.0, 255.0)
    return hsv_to_rgb_u8(torch.stack([h, s, v], dim=-1))


def apply_color(images: torch.Tensor,
                mix_images: Optional[torch.Tensor] = None,
                mix_weight: Optional[torch.Tensor] = None,
                hsv_deltas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused device color stage: blend -> HSV jitter.

    images, mix_images: (B, H, W, 3) uint8 (or float32 codes)
    mix_weight: (B,) f32; 1.0 = no mixup (mix_images ignored), 0.5 = the
        YOLOX recipe's fixed blend
    hsv_deltas: (B, 3) f32 integer deltas
    Returns (B, H, W, 3) f32 uint8-codes (un-normalized).

    ``mix_images`` / ``hsv_deltas`` may be None (stage statically off):
    a pipeline with hsv off must be an exact no-op on pixels (the uint8
    HSV round trip at zero deltas is not one), and a mixup-off pipeline
    must not pay the blend.  The blend truncates like the host's
    ``.astype(np.uint8)`` (values are non-negative, floor == trunc)."""
    out = images.float()
    if mix_images is not None:
        w = mix_weight.float()[:, None, None, None]
        out = torch.floor(out * w + mix_images.float() * (1.0 - w))
    if hsv_deltas is not None:
        out = hsv_jitter(out, hsv_deltas.float()[:, None, None, :])
    return out


def apply_batch_color(batch: dict,
                      out_hw: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """Resolve a train batch's images: render them with the device
    geometric warp when the pipeline deferred it (``geom_*`` keys,
    ``data/device_geom.py``), then run :func:`apply_color` for whichever
    color keys the batch carries.  A plain batch's ``images`` come back
    as they are.  Split from :func:`prep_batch_images` because the
    multi-scale step resizes between color and normalize.

    out_hw: the output size, required only for geom batches (they carry
    no ``images`` tensor to infer it from)."""
    if "geom_sources" in batch:
        from glsdet_tpu_torch.data.device_geom import geom_warp

        if out_hw is None:
            raise ValueError("geom batches need out_hw")
        images = geom_warp(batch["geom_sources"], batch["geom_quads"],
                           batch["geom_mat"], out_hw)
    else:
        images = batch["images"]
    if "mix_images" in batch or "hsv_deltas" in batch:
        images = apply_color(images, batch.get("mix_images"),
                             batch.get("mix_weight"),
                             batch.get("hsv_deltas"))
    return images


def normalize_images(images: torch.Tensor, normalize: bool = True,
                     mean: Optional[torch.Tensor] = None,
                     std: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ImageNet-normalise uint8-code images (..., 3) in float32; a no-op
    when ``normalize`` is False (batches already normalised).  ``mean``
    and ``std`` default to :func:`imagenet_stats` on the images'
    device."""
    if not normalize:
        return images
    if mean is None or std is None:
        mean, std = imagenet_stats(images.device)
    return (images.float() - mean) / std


def prep_batch_images(batch: dict, normalize: bool) -> torch.Tensor:
    """:func:`apply_batch_color`, then :func:`normalize_images`."""
    return normalize_images(apply_batch_color(batch), normalize)
