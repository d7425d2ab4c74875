"""Detection drawing, the port's counterpart of
``glsdet_tpu.utils.visualize.draw_detections`` (``Detector.detect_image``
and ``run_eval(show_dir=...)`` draw with it).  It draws in numpy, since
the GPU machine has no OpenCV: each box's outline in its class's colour,
without the label text (there is no font to draw it with)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# deterministic per-class palette
_PALETTE = [
    (220, 20, 60), (119, 172, 48), (0, 114, 189), (237, 177, 32),
    (126, 47, 142), (77, 190, 238), (162, 20, 47), (0, 128, 128),
    (210, 105, 30), (60, 180, 75), (230, 25, 75), (67, 99, 216),
]


def draw_detections(image: np.ndarray, boxes: np.ndarray,
                    scores: np.ndarray, labels: np.ndarray,
                    class_names: Optional[Sequence[str]] = None,
                    score_thr: float = 0.3,
                    thickness: int = 2) -> np.ndarray:
    """Draw xyxy detections on an RGB uint8 image; returns a copy.  The
    class shows as the outline's colour; ``class_names`` is taken for the
    JAX signature and not drawn."""
    out = image.copy()
    h, w = out.shape[:2]
    t = max(int(thickness), 1)

    def band(r0, r1, c0, c1, color):
        out[max(r0, 0):max(min(r1, h), 0),
            max(c0, 0):max(min(c1, w), 0)] = color

    for box, score, label in zip(boxes, scores, labels):
        if score < score_thr:
            continue
        color = _PALETTE[int(label) % len(_PALETTE)]
        x1, y1, x2, y2 = (int(v) for v in box)
        x1, x2, y1, y2 = min(x1, x2), max(x1, x2), min(y1, y2), max(y1, y2)
        band(y1, y1 + t, x1, x2 + 1, color)
        band(y2 - t + 1, y2 + 1, x1, x2 + 1, color)
        band(y1, y2 + 1, x1, x1 + t, color)
        band(y1, y2 + 1, x2 - t + 1, x2 + 1, color)
    return out
