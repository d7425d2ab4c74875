"""Image normalization constants, the port's copy of what the serving
facades take from ``glsdet_tpu.data.coco``.  The dataset reader is still
to be ported (ROADMAP.md, queue A item 11)."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def normalize(img: np.ndarray, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> np.ndarray:
    return (img.astype(np.float32) - mean) / std
