"""Detection drawing, the port's copy of
``glsdet_tpu.utils.visualize.draw_detections`` (``Detector.detect_image``
draws with it).  OpenCV is imported when it draws: the GPU machine has
none, and serving does not need it."""

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
    """Draw xyxy detections on an RGB uint8 image; returns a copy."""
    import cv2

    out = image.copy()
    for box, score, label in zip(boxes, scores, labels):
        if score < score_thr:
            continue
        color = _PALETTE[int(label) % len(_PALETTE)]
        x1, y1, x2, y2 = (int(v) for v in box)
        cv2.rectangle(out, (x1, y1), (x2, y2), color, thickness)
        name = (class_names[int(label)] if class_names
                else str(int(label)))
        txt = f"{name} {score:.2f}"
        (tw, th), _ = cv2.getTextSize(txt, cv2.FONT_HERSHEY_SIMPLEX,
                                      0.5, 1)
        cv2.rectangle(out, (x1, max(y1 - th - 4, 0)),
                      (x1 + tw, y1), color, -1)
        cv2.putText(out, txt, (x1, max(y1 - 2, th)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1,
                    cv2.LINE_AA)
    return out
