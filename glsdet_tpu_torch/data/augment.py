"""Host-side training augmentations of the YOLOX recipe, the port's copy
of ``glsdet_tpu.data.augment``'s ``letterbox``, ``sample_hsv_deltas``,
``hsv_aug``, ``random_flip``, ``mosaic4_params``, ``mosaic4_boxes``,
``mosaic4``, ``random_affine_params``, ``random_affine``,
``affine_boxes`` and ``mixup`` (reference: ``yolox-ufp/mmdet/datasets/
pipelines/transforms.py`` Mosaic :1947, RandomAffine :2480, MixUp
:2216, YOLOXHSVRandomAug :2698).

Parameter sampling and box geometry are the JAX package's numpy code,
carried over line for line: the same ``RandomState`` draws in the same
order give bit-equal boxes.  The pixels go through the port's own
counterparts of the OpenCV calls, each held to the OpenCV of the JAX
package's tests value for value (``tests/test_torch_augment.py``):

- ``cv2.resize`` (INTER_LINEAR) -> ``ops/image.py: resize_linear_u8``;
- ``cv2.warpAffine`` -> ``ops/image.py: warp_affine_u8``;
- ``cv2.cvtColor`` RGB <-> HSV on uint8 -> :func:`rgb_to_hsv_cv` and
  :func:`hsv_to_rgb_cv` below.

The rest of the JAX module (``random_crop``, ``photometric_distortion``,
the auto-augment family, ``Albu``) is not ported yet (ROADMAP.md, queue
A item 11).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from glsdet_tpu_torch.ops.image import resize_linear_u8, warp_affine_u8

_F32 = np.float32
_HSV_SHIFT = 12
_i = np.arange(256, dtype=np.float64)
# OpenCV's RGB2HSV_b divide tables: round((255 << 12) / v) and
# round((180 << 12) / (6 * diff)), 0 at 0
_SDIV = np.rint(np.where(_i > 0, (255 << _HSV_SHIFT) / np.maximum(_i, 1),
                         0)).astype(np.int64)
_HDIV = np.rint(np.where(_i > 0, (180 << _HSV_SHIFT)
                         / (6.0 * np.maximum(_i, 1)), 0)).astype(np.int64)
# OpenCV's HSV2RGB sector table: tab indices of (b, g, r) per sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])
# pixels per vector block of OpenCV's HSV2RGB_b (an AVX2 build); the
# pixels past the last block take the scalar tail, which rounds where
# the blocks truncate
HSV_BLOCK = 32


def _u8(img: np.ndarray) -> torch.Tensor:
    # the decode cache's frames are read-only: torch wants its own copy
    img = np.ascontiguousarray(img)
    return torch.from_numpy(img if img.flags.writeable else img.copy())


def resize_u8(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` on a uint8 frame."""
    return resize_linear_u8(_u8(img), (wh[1], wh[0])).numpy()


def rgb_to_hsv_cv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` on uint8 (H in [0, 180)):
    OpenCV's integer algorithm with its 12-bit divide tables."""
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product is exact in
    float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def hsv_to_rgb_cv(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` on uint8: s and v scaled
    by 1/255 in float32, ``h * (6/180)`` split into its sector (truncated)
    and fraction f, the sector's taps ``v``, ``v (1 - s)``, ``v fma(-s,
    f, 1)`` and ``v fma(-s, 1 - f, 1)``, times 255, truncated in the
    vector blocks of ``HSV_BLOCK`` pixels of each row and rounded in the
    row's tail."""
    one = _F32(1)
    inv = _F32(1.0 / 255.0)
    h = hsv[..., 0].astype(_F32)
    s = hsv[..., 1].astype(_F32) * inv
    v = hsv[..., 2].astype(_F32) * inv
    hh = h * _F32(6.0 / 180.0)
    pre = np.trunc(hh)
    f = hh - pre
    sector = (pre - np.trunc(pre * _F32(1.0 / 6.0)) * _F32(6)).astype(
        np.int64)
    tab = np.stack([v, v * (one - s), v * _fma(-s, f, one),
                    v * _fma(-s, one - f, one)], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector % 6], axis=-1)
    rgb = bgr[..., ::-1] * _F32(255)
    out = np.trunc(rgb)
    w = out.shape[-2]
    tail = w - w % HSV_BLOCK
    out[..., tail:, :] = np.rint(rgb[..., tail:, :])
    return np.clip(out, 0, 255).astype(np.uint8)


def letterbox(img: np.ndarray, boxes: np.ndarray, size: Tuple[int, int],
              pad_val: float = 114.0):
    """Keep-ratio resize + center pad to ``size`` (h, w). Returns
    (image, boxes, scale, (dx, dy))."""
    h0, w0 = img.shape[:2]
    h, w = size
    scale = min(h / h0, w / w0)
    nw, nh = int(round(w0 * scale)), int(round(h0 * scale))
    resized = resize_u8(img, (nw, nh))
    out = np.full((h, w, 3), pad_val, img.dtype)
    dx, dy = (w - nw) // 2, (h - nh) // 2
    out[dy:dy + nh, dx:dx + nw] = resized
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, [0, 2]] = boxes[:, [0, 2]] * scale + dx
        boxes[:, [1, 3]] = boxes[:, [1, 3]] * scale + dy
    return out, boxes, scale, (dx, dy)


def sample_hsv_deltas(rng: np.random.RandomState, h_delta: int = 5,
                      s_delta: int = 30, v_delta: int = 30) -> np.ndarray:
    """Draw the YOLOXHSVRandomAug (dh, ds, dv) integer deltas; the host
    path (:func:`hsv_aug`) and the device path (``device_color``
    batches) consume the same draws."""
    return np.array([int(rng.uniform(-h_delta, h_delta)),
                     int(rng.uniform(-s_delta, s_delta)),
                     int(rng.uniform(-v_delta, v_delta))], np.float32)


def hsv_aug(img: np.ndarray, rng: np.random.RandomState,
            h_delta: int = 5, s_delta: int = 30, v_delta: int = 30):
    """YOLOXHSVRandomAug (transforms.py:2698): random HSV jitter."""
    dh, ds, dv = sample_hsv_deltas(rng, h_delta, s_delta, v_delta)
    hsv = rgb_to_hsv_cv(img).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + int(dh)) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + int(ds), 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + int(dv), 0, 255)
    return hsv_to_rgb_cv(hsv.astype(np.uint8))


def random_flip(img: np.ndarray, boxes: np.ndarray,
                rng: np.random.RandomState, prob: float = 0.5):
    if rng.rand() < prob:
        img = img[:, ::-1]
        if len(boxes):
            w = img.shape[1]
            boxes = boxes.copy()
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return img, boxes


def mosaic4_params(shapes: Sequence[Tuple[int, int]],
                   out_size: Tuple[int, int],
                   rng: np.random.RandomState, center_ratio=(0.5, 1.5)):
    """Sample the mosaic placement: returns (cx, cy, quads) where
    ``quads[i] = (x1, y1, x2, y2, sx1, sy1, scale, nw, nh)`` describes
    where image i's keep-ratio-resized copy lands on the 2x canvas and
    which part of it is cropped (shared by :func:`mosaic4` and the
    device gather-warp, ``data/device_geom.py``)."""
    h, w = out_size
    cy = int(rng.uniform(*center_ratio) * h)
    cx = int(rng.uniform(*center_ratio) * w)
    quads = []
    for loc, (h0, w0) in zip(["tl", "tr", "bl", "br"], shapes):
        scale = min(h / h0, w / w0)
        nw, nh = int(w0 * scale), int(h0 * scale)
        if loc == "tl":
            x1, y1 = max(cx - nw, 0), max(cy - nh, 0)
            x2, y2 = cx, cy
            sx1, sy1 = nw - (x2 - x1), nh - (y2 - y1)
        elif loc == "tr":
            x1, y1 = cx, max(cy - nh, 0)
            x2, y2 = min(cx + nw, w * 2), cy
            sx1, sy1 = 0, nh - (y2 - y1)
        elif loc == "bl":
            x1, y1 = max(cx - nw, 0), cy
            x2, y2 = cx, min(cy + nh, h * 2)
            sx1, sy1 = nw - (x2 - x1), 0
        else:
            x1, y1 = cx, cy
            x2, y2 = min(cx + nw, w * 2), min(cy + nh, h * 2)
            sx1, sy1 = 0, 0
        quads.append((x1, y1, x2, y2, sx1, sy1, scale, nw, nh))
    return cx, cy, quads


def mosaic4_boxes(quads, boxes_list, labels_list,
                  out_size: Tuple[int, int]):
    """The box half of :func:`mosaic4` for given placements."""
    h, w = out_size
    all_boxes, all_labels = [], []
    for (x1, y1, _x2, _y2, sx1, sy1, scale, _nw, _nh), boxes, labels in zip(
            quads, boxes_list, labels_list):
        if len(boxes):
            b = boxes.copy() * scale
            b[:, [0, 2]] += x1 - sx1
            b[:, [1, 3]] += y1 - sy1
            all_boxes.append(b)
            all_labels.append(labels)
    if all_boxes:
        boxes = np.concatenate(all_boxes)
        labels = np.concatenate(all_labels)
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * h)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        boxes, labels = boxes[keep], labels[keep]
    else:
        boxes = np.zeros((0, 4), np.float32)
        labels = np.zeros((0,), np.int32)
    return boxes.astype(np.float32), labels


def mosaic4(images: Sequence[np.ndarray], boxes_list: Sequence[np.ndarray],
            labels_list: Sequence[np.ndarray], out_size: Tuple[int, int],
            rng: np.random.RandomState, center_ratio=(0.5, 1.5),
            pad_val: float = 114.0):
    """4-image mosaic (transforms.py:1947): 2x canvas, random center split,
    each image keep-ratio scaled into its quadrant; boxes clipped."""
    h, w = out_size
    canvas = np.full((h * 2, w * 2, 3), pad_val, np.uint8)
    _cx, _cy, quads = mosaic4_params(
        [img.shape[:2] for img in images], out_size, rng, center_ratio)
    for (x1, y1, x2, y2, sx1, sy1, _scale, nw, nh), img in zip(
            quads, images):
        img_r = resize_u8(img, (nw, nh))
        canvas[y1:y2, x1:x2] = img_r[sy1:sy1 + (y2 - y1),
                                     sx1:sx1 + (x2 - x1)]

    boxes, labels = mosaic4_boxes(quads, boxes_list, labels_list, out_size)
    return canvas, boxes, labels


def random_affine_params(rng: np.random.RandomState,
                         in_size: Tuple[int, int],
                         out_size: Tuple[int, int],
                         max_rotate: float = 10.0,
                         max_translate: float = 0.1,
                         scale_range: Tuple[float, float] = (0.5, 1.5),
                         max_shear: float = 2.0) -> np.ndarray:
    """Sample the RandomAffine 3x3 matrix (canvas -> output coords);
    shared by :func:`random_affine` and the device gather-warp."""
    h, w = out_size
    h0, w0 = in_size
    ang = math.radians(rng.uniform(-max_rotate, max_rotate))
    scale = rng.uniform(*scale_range)
    shear_x = math.tan(math.radians(rng.uniform(-max_shear, max_shear)))
    shear_y = math.tan(math.radians(rng.uniform(-max_shear, max_shear)))
    tx = rng.uniform(0.5 - max_translate, 0.5 + max_translate) * w
    ty = rng.uniform(0.5 - max_translate, 0.5 + max_translate) * h

    # center -> rotate/scale -> shear -> translate
    cxm = np.array([[1, 0, -w0 / 2], [0, 1, -h0 / 2], [0, 0, 1]], np.float64)
    rot = np.array([
        [math.cos(ang) * scale, -math.sin(ang) * scale, 0],
        [math.sin(ang) * scale, math.cos(ang) * scale, 0],
        [0, 0, 1]], np.float64)
    shr = np.array([[1, shear_x, 0], [shear_y, 1, 0], [0, 0, 1]], np.float64)
    trn = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float64)
    return trn @ shr @ rot @ cxm


def random_affine(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                  rng: np.random.RandomState,
                  out_size: Tuple[int, int],
                  max_rotate: float = 10.0, max_translate: float = 0.1,
                  scale_range: Tuple[float, float] = (0.5, 1.5),
                  max_shear: float = 2.0, pad_val: float = 114.0,
                  border: Optional[Tuple[int, int]] = None):
    """RandomAffine (transforms.py:2480): rot/scale/shear/translate about
    the canvas center, typically halving the 2x mosaic canvas back to
    ``out_size``; boxes warped by the same matrix and filtered."""
    h0, w0 = img.shape[:2]
    mat = random_affine_params(rng, (h0, w0), out_size, max_rotate,
                               max_translate, scale_range, max_shear)
    out = warp_affine_u8(_u8(img), mat[:2], out_size,
                         border_value=int(pad_val)).numpy()
    boxes, labels = affine_boxes(mat, boxes, labels, out_size)
    return out, boxes, labels


def affine_boxes(mat: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                 out_size: Tuple[int, int]):
    """The box half of :func:`random_affine`: warp corners by ``mat``,
    re-box, clip, filter sides > 2px."""
    h, w = out_size
    if len(boxes):
        n = len(boxes)
        corners = np.ones((n * 4, 3), np.float64)
        corners[:, :2] = boxes[:, [0, 1, 2, 1, 0, 3, 2, 3]].reshape(-1, 2)
        warped = (mat @ corners.T).T[:, :2].reshape(n, 8)
        xs = warped[:, 0::2]
        ys = warped[:, 1::2]
        new = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        wh = new[:, 2:4] - new[:, :2]
        keep = (wh > 2).all(axis=1)
        boxes, labels = new[keep].astype(np.float32), labels[keep]
    return boxes, labels


def mixup(img_a, boxes_a, labels_a, img_b, boxes_b, labels_b,
          rng: np.random.RandomState, alpha: float = 0.5):
    """MixUp (transforms.py:2216, ratio fixed ~0.5 in YOLOX recipe):
    blends a second (letterboxed) image and concatenates its GTs."""
    out = (img_a.astype(np.float32) * alpha
           + img_b.astype(np.float32) * (1 - alpha)).astype(np.uint8)
    boxes = np.concatenate([boxes_a, boxes_b]) if len(boxes_b) else boxes_a
    labels = (np.concatenate([labels_a, labels_b])
              if len(labels_b) else labels_a)
    return out, boxes, labels
