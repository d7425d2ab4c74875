"""Ignore-region filtering for UAVDT/VisDrone evaluation: the port's copy
of ``glsdet_tpu.eval.ignore``, pinned to it by ``tests/test_torch_eval.py``.

Behavioral reference: ``yolox-ufp/uav_eval.py`` / ``myuav_eval.py`` —
detections whose center falls inside an annotated ignore region are
dropped before scoring (UAVDT protocol), mirroring how the UFP dataset
tool blanks ignore regions in the pixels.
"""

from __future__ import annotations

import numpy as np


def filter_ignore_regions(boxes: np.ndarray, scores: np.ndarray,
                          labels: np.ndarray,
                          ignore_boxes: np.ndarray):
    """Drop detections centered inside any ignore region.

    boxes: (N, 4) xyxy; ignore_boxes: (M, 4) xyxy.
    """
    if len(boxes) == 0 or ignore_boxes is None or len(ignore_boxes) == 0:
        return boxes, scores, labels
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    inside = np.zeros(len(boxes), bool)
    for ig in ignore_boxes:
        inside |= ((cx >= ig[0]) & (cx <= ig[2])
                   & (cy >= ig[1]) & (cy <= ig[3]))
    keep = ~inside
    return boxes[keep], scores[keep], labels[keep]
