"""Plots drawn in numpy, where the JAX package plots with matplotlib
(the GPU machine has none); callers write them with
``data/image_io.write_png``.  ``utils/observe.py:
LossHistory``'s ``epoch_loss.png``, ``tools/analyze_logs.py``'s curves,
``tools/coco_error_analysis.py``'s PR panels and
``tools/confusion_matrix.py``'s heat map share it; ``tools/draw_cam.py``
colours its map with :data:`JET`.

The plots carry no text (no axis labels, ticks, titles or legends):
there is no font to draw it with.  A line plot is a light grey 8x8 grid
over the plot area with each curve in its colour; a heat map is one
square block per cell on the Blues ramp, light (0) to dark (1).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# matplotlib's default colour cycle, for curves drawn in order
CYCLE = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
         (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127))
# ColorBrewer's 9-class Blues, matplotlib's "Blues" anchors
BLUES = np.array([(247, 251, 255), (222, 235, 247), (198, 219, 239),
                  (158, 202, 225), (107, 174, 214), (66, 146, 198),
                  (33, 113, 181), (8, 81, 156), (8, 48, 107)], np.float64)

# OpenCV's COLORMAP_JET, 256 RGB entries (``cv2.applyColorMap`` reads
# entry v for code v; ``tests/test_torch_tools_model.py`` holds it to
# cv2 for all 256 codes)
JET = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000"
    "a80000ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d000"
    "00d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028"
    "ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff00"
    "54ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8"
    "ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00"
    "d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2aff"
    "d62effd232ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56"
    "ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff"
    "56aeff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6"
    "ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd4"
    "00ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000ffac00ff"
    "a800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff54"
    "00ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff"
    "2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d400"
    "00d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac0000a8"
    "0000a40000a000009c00009800009400009000008c0000880000840000800000"), np.uint8).reshape(256, 3)



def _span(lo: float, hi: float) -> float:
    return hi - lo if hi > lo else 1.0


def line_plot(curves: Sequence[Tuple[Sequence[float], Sequence[float],
                                     Tuple[int, int, int]]],
              x_range: Optional[Tuple[float, float]] = None,
              y_range: Optional[Tuple[float, float]] = None,
              size: Tuple[int, int] = (480, 640), pad: int = 40
              ) -> np.ndarray:
    """(h, w, 3) uint8 RGB: ``curves`` as ``(xs, ys, colour)``, each a
    2-3 pixel wide polyline.  The axes span ``x_range`` / ``y_range``
    (default: the curves' own extent)."""
    h, w = size
    img = np.full((h, w, 3), 255, np.uint8)
    img[pad:h - pad + 1:(h - 2 * pad) // 8, pad:w - pad] = 220  # grid
    img[pad:h - pad, pad:w - pad + 1:(w - 2 * pad) // 8] = 220
    if not curves:
        return img
    if x_range is None:
        xs = np.concatenate([np.asarray(c[0], np.float64) for c in curves])
        x_range = (float(xs.min()), float(xs.max()))
    if y_range is None:
        ys = np.concatenate([np.asarray(c[1], np.float64) for c in curves])
        y_range = (float(ys.min()), float(ys.max()))
    x0, xspan = x_range[0], _span(*x_range)
    lo, span = y_range[0], _span(*y_range)
    for xs, ys, color in curves:
        if len(ys) == 0:
            continue
        x = pad + (np.asarray(xs, np.float64) - x0) * (w - 2 * pad) / xspan
        y = h - pad - (np.asarray(ys, np.float64) - lo) / span * (
            h - 2 * pad)
        if len(ys) == 1:
            x, y = np.repeat(x, 2), np.repeat(y, 2)
        t = np.linspace(0.0, 1.0, 64)[:, None]
        px = (x[:-1] + t * (x[1:] - x[:-1])).ravel()
        py = (y[:-1] + t * (y[1:] - y[:-1])).ravel()
        for d in (-1, 0, 1):        # a 2-3 pixel wide line
            img[np.clip(np.round(py).astype(int) + d, 0, h - 1),
                np.clip(np.round(px).astype(int), 0, w - 1)] = color
    return img


def heat_map(mat: np.ndarray, cell: int = 40, pad: int = 20) -> np.ndarray:
    """(h, w, 3) uint8 RGB of an (R, C) matrix of values in [0, 1]
    (clipped): one ``cell``-pixel block per entry on the Blues ramp,
    light grey lines between the blocks."""
    m = np.clip(np.nan_to_num(np.asarray(mat, np.float64)), 0.0, 1.0)
    pos = m * (len(BLUES) - 1)
    i = np.minimum(np.floor(pos).astype(int), len(BLUES) - 2)
    f = (pos - i)[..., None]
    rgb = np.round(BLUES[i] * (1 - f) + BLUES[i + 1] * f).astype(np.uint8)
    r, c = m.shape
    img = np.full((r * cell + 2 * pad, c * cell + 2 * pad, 3), 255, np.uint8)
    img[pad:pad + r * cell, pad:pad + c * cell] = np.repeat(
        np.repeat(rgb, cell, axis=0), cell, axis=1)
    img[pad:pad + r * cell + 1:cell, pad:pad + c * cell] = 220
    img[pad:pad + r * cell, pad:pad + c * cell + 1:cell] = 220
    return img

