"""The device side of a train batch's images, the counterpart of
``glsdet_tpu.data.device_color`` for the plain batch contract: ``images``
(B, H, W, 3) uint8 RGB, normalised on the device.

The JAX package also renders its augmentations here (the deferred
geometric warp, the mixup blend, the HSV jitter) from batch keys that
its data pipeline emits; that pipeline is still to be ported, so a batch
carrying those keys raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from glsdet_tpu_torch.data.coco import IMAGENET_MEAN, IMAGENET_STD

_PIPELINE_KEYS = ("geom_sources", "geom_quads", "geom_mat", "mix_images",
                  "mix_weight", "hsv_deltas")


def imagenet_stats(device) -> tuple:
    """(mean, std) float32 tensors on ``device``, to make once and pass
    to :func:`normalize_images` (a host-to-device copy waits for the
    card)."""
    return (torch.from_numpy(IMAGENET_MEAN).to(device),
            torch.from_numpy(IMAGENET_STD).to(device))


def apply_batch_color(batch: dict) -> torch.Tensor:
    """The batch's ``images``.  The augmentation keys of the JAX
    package's data pipeline are not supported yet."""
    found = [k for k in _PIPELINE_KEYS if k in batch]
    if found:
        raise NotImplementedError(
            f"batch keys {found}: the device augmentations come with the "
            "data pipeline, which is not ported yet (ROADMAP.md, queue A "
            "item 11)")
    return batch["images"]


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
