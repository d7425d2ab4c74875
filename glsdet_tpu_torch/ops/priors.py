"""Multi-level point and anchor priors (numpy), the counterparts of
``glsdet_tpu.ops.priors``; priors are static per input size, so they
are built on the host once and moved to the device by their user."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def featmap_sizes(img_hw: Tuple[int, int],
                  strides: Sequence[int]) -> List[Tuple[int, int]]:
    h, w = img_hw
    return [(int(np.ceil(h / s)), int(np.ceil(w / s))) for s in strides]


def grid_points(img_hw: Tuple[int, int], strides: Sequence[int],
                offset: float = 0.5
                ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Flattened multi-level prior centers: (A, 2) centers in image
    coordinates, (A,) strides, per-level counts."""
    centers, strs, counts = [], [], []
    for (h, w), s in zip(featmap_sizes(img_hw, strides), strides):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        cx = (xs.reshape(-1) + offset) * s
        cy = (ys.reshape(-1) + offset) * s
        centers.append(np.stack([cx, cy], axis=-1))
        strs.append(np.full((h * w,), s))
        counts.append(h * w)
    return (np.concatenate(centers, 0).astype(np.float32),
            np.concatenate(strs, 0).astype(np.float32), counts)


def grid_anchors(img_hw: Tuple[int, int], strides: Sequence[int],
                 octave_base_scale: float = 8.0,
                 center_offset: float = 0.0
                 ) -> Tuple[np.ndarray, List[int]]:
    """One square anchor of side ``octave_base_scale * stride`` per
    location (GFL/ATSS): (A, 4) xyxy anchors and per-level counts."""
    anchors, counts = [], []
    for (h, w), s in zip(featmap_sizes(img_hw, strides), strides):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        cx = (xs.reshape(-1) + center_offset) * s
        cy = (ys.reshape(-1) + center_offset) * s
        half = octave_base_scale * s / 2.0
        anchors.append(
            np.stack([cx - half, cy - half, cx + half, cy + half], axis=-1))
        counts.append(h * w)
    return np.concatenate(anchors, 0).astype(np.float32), counts


def anchor_centers(anchors: np.ndarray) -> np.ndarray:
    return (anchors[:, :2] + anchors[:, 2:4]) / 2.0
