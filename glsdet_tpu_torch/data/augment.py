"""Host-side training augmentations, the port's copy of
``glsdet_tpu.data.augment``: the YOLOX recipe (``letterbox``,
``sample_hsv_deltas``, ``hsv_aug``, ``random_flip``, ``mosaic4_params``,
``mosaic4_boxes``, ``mosaic4``, ``random_affine_params``,
``random_affine``, ``affine_boxes``, ``mixup``; reference:
``yolox-ufp/mmdet/datasets/pipelines/transforms.py`` Mosaic :1947,
RandomAffine :2480, MixUp :2216, YOLOXHSVRandomAug :2698), mmdet's
``random_crop`` and ``photometric_distortion`` (transforms.py :712,
:940), the box-aware AutoAugment family (``shear_aug``, ``rotate_aug``,
``translate_aug``, ``color_aug``, ``brightness_aug``, ``contrast_aug``,
``equalize_aug``, ``AUTOAUG_POLICIES_V0``, ``auto_augment``; mmdet
``auto_augment.py``) and the ``Albu`` bridge (transforms.py:1320).

Parameter sampling and box geometry are the JAX package's numpy code,
carried over line for line: the same ``RandomState`` draws in the same
order give bit-equal boxes.  The pixels go through the port's own
counterparts of the OpenCV calls, each held to the OpenCV of the JAX
package's tests value for value (``tests/test_torch_augment.py``,
``tests/test_torch_autoaugment.py``):

- ``cv2.resize`` (INTER_LINEAR) -> ``ops/image.py: resize_linear_u8``;
- ``cv2.warpAffine`` -> ``ops/image.py: warp_affine_u8``;
- ``cv2.getRotationMatrix2D`` -> ``ops/image.py: rotation_matrix_2d``;
- ``cv2.cvtColor`` RGB2GRAY -> ``ops/image.py: rgb_to_gray_u8``;
- ``cv2.equalizeHist`` -> ``ops/image.py: equalize_hist_u8``;
- ``cv2.cvtColor`` RGB <-> HSV on uint8 -> :func:`rgb_to_hsv_cv` and
  :func:`hsv_to_rgb_cv` below.

The arithmetic around those calls stays the JAX package's numpy
expressions, dtypes included (``contrast_aug`` adds a float64 mean to a
float32 image, which NumPy 2 computes in float64).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from glsdet_tpu_torch.ops.image import (equalize_hist_u8, resize_linear_u8,
                                        rgb_to_gray_u8, rotation_matrix_2d,
                                        warp_affine_u8)

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
                         border_value=pad_val).numpy()
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


def random_crop(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                rng: np.random.RandomState,
                crop_hw: Tuple[int, int]):
    """RandomCrop (transforms.py:712): crop a window, shift boxes, drop
    boxes whose center leaves the window."""
    h0, w0 = img.shape[:2]
    ch, cw = min(crop_hw[0], h0), min(crop_hw[1], w0)
    y0 = rng.randint(0, h0 - ch + 1)
    x0 = rng.randint(0, w0 - cw + 1)
    out = img[y0:y0 + ch, x0:x0 + cw]
    if len(boxes):
        b = boxes.copy()
        b[:, [0, 2]] -= x0
        b[:, [1, 3]] -= y0
        cx = (b[:, 0] + b[:, 2]) / 2
        cy = (b[:, 1] + b[:, 3]) / 2
        keep = (cx >= 0) & (cx < cw) & (cy >= 0) & (cy < ch)
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, cw)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, ch)
        boxes, labels = b[keep], labels[keep]
    return out, boxes, labels


def photometric_distortion(img: np.ndarray, rng: np.random.RandomState,
                           brightness_delta: int = 32,
                           contrast_range=(0.5, 1.5),
                           saturation_range=(0.5, 1.5),
                           hue_delta: int = 18) -> np.ndarray:
    """PhotoMetricDistortion (transforms.py:940): random brightness /
    contrast / saturation / hue, each applied with p=0.5, contrast order
    randomized."""
    out = img.astype(np.float32)
    if rng.randint(2):
        out += rng.uniform(-brightness_delta, brightness_delta)
    contrast_first = rng.randint(2)
    if contrast_first and rng.randint(2):
        out *= rng.uniform(*contrast_range)
    hsv = rgb_to_hsv_cv(out.clip(0, 255).astype(np.uint8)).astype(np.float32)
    if rng.randint(2):
        hsv[..., 1] *= rng.uniform(*saturation_range)
    if rng.randint(2):
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue_delta, hue_delta)) % 180
    out = hsv_to_rgb_cv(hsv.clip(0, 255).astype(np.uint8)).astype(np.float32)
    if not contrast_first and rng.randint(2):
        out *= rng.uniform(*contrast_range)
    return out.clip(0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# AutoAugment (box-aware policy augmentation)
# ---------------------------------------------------------------------------
# Behavioral reference: mmdet/datasets/pipelines/auto_augment.py —
# ``AutoAugment`` picks ONE policy (a list of op dicts, each with its own
# ``prob``) uniformly per sample; geometric ops (Shear/Rotate/Translate)
# warp boxes with the image and drop boxes that leave the canvas;
# photometric ops (Color/Brightness/Contrast/Equalize) touch pixels only.
# ``level`` in [0, 10] scales each op's magnitude exactly as the
# reference's ``level_to_value`` / ``level_to_mag`` helpers do.

_MAX_LEVEL = 10


def _warp_with_boxes(img, boxes, labels, mat, pad_val=128.0,
                     min_size=2.0):
    """Apply a 2x3 affine to image + boxes on the same canvas; boxes are
    re-fit to warped corners, clipped, and dropped below ``min_size``."""
    h, w = img.shape[:2]
    out = warp_affine_u8(_u8(img), mat, (h, w),
                         border_value=pad_val).numpy()
    if len(boxes):
        n = len(boxes)
        corners = np.ones((n * 4, 3), np.float64)
        corners[:, :2] = boxes[:, [0, 1, 2, 1, 0, 3, 2, 3]].reshape(-1, 2)
        warped = (np.vstack([mat, [0, 0, 1]]) @ corners.T).T[:, :2]
        warped = warped.reshape(n, 8)
        xs, ys = warped[:, 0::2], warped[:, 1::2]
        new = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        wh = new[:, 2:4] - new[:, :2]
        keep = (wh > min_size).all(axis=1)
        boxes, labels = new[keep].astype(np.float32), labels[keep]
    return out, boxes, labels


def shear_aug(img, boxes, labels, rng, level, direction="horizontal",
              max_shear_magnitude=0.3, prob=0.5, random_negative=True):
    """Shear (auto_augment.py Shear): magnitude = level/10 * 0.3."""
    if rng.rand() > prob:
        return img, boxes, labels
    mag = level / _MAX_LEVEL * max_shear_magnitude
    if random_negative and rng.rand() < 0.5:
        mag = -mag
    if direction == "horizontal":
        mat = np.array([[1, mag, 0], [0, 1, 0]], np.float64)
    else:
        mat = np.array([[1, 0, 0], [mag, 1, 0]], np.float64)
    return _warp_with_boxes(img, boxes, labels, mat)


def rotate_aug(img, boxes, labels, rng, level, max_rotate_angle=30.0,
               prob=0.5, random_negative=True):
    """Rotate (auto_augment.py Rotate): angle = level/10 * 30deg about
    the image center."""
    if rng.rand() > prob:
        return img, boxes, labels
    ang = level / _MAX_LEVEL * max_rotate_angle
    if random_negative and rng.rand() < 0.5:
        ang = -ang
    h, w = img.shape[:2]
    mat = rotation_matrix_2d((w / 2, h / 2), ang, 1.0)
    return _warp_with_boxes(img, boxes, labels, mat)


def translate_aug(img, boxes, labels, rng, level,
                  direction="horizontal", max_translate_offset=250.0,
                  prob=0.5, random_negative=True):
    """Translate (auto_augment.py Translate): offset = level/10 * 250px."""
    if rng.rand() > prob:
        return img, boxes, labels
    off = int(level / _MAX_LEVEL * max_translate_offset)
    if random_negative and rng.rand() < 0.5:
        off = -off
    if direction == "horizontal":
        mat = np.array([[1, 0, off], [0, 1, 0]], np.float64)
    else:
        mat = np.array([[1, 0, 0], [0, 1, off]], np.float64)
    return _warp_with_boxes(img, boxes, labels, mat)


def _gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` of a uint8 RGB frame."""
    return rgb_to_gray_u8(_u8(img)).numpy()


def color_aug(img, rng, level, prob=0.5):
    """ColorTransform: blend with grayscale, factor = level/10."""
    if rng.rand() > prob:
        return img
    factor = level / _MAX_LEVEL
    gray = _gray(img)[..., None]
    out = (img.astype(np.float32) * factor
           + gray.astype(np.float32) * (1 - factor))
    return out.clip(0, 255).astype(np.uint8)


def brightness_aug(img, rng, level, prob=0.5):
    """BrightnessTransform: scale toward black, factor = level/10."""
    if rng.rand() > prob:
        return img
    factor = level / _MAX_LEVEL
    return (img.astype(np.float32) * factor).clip(0, 255).astype(np.uint8)


def contrast_aug(img, rng, level, prob=0.5):
    """ContrastTransform: blend with the mean-gray image (the mean is a
    numpy float64, so the blend runs in float64 as the JAX package's
    does)."""
    if rng.rand() > prob:
        return img
    factor = level / _MAX_LEVEL
    mean = _gray(img).mean()
    out = img.astype(np.float32) * factor + mean * (1 - factor)
    return out.clip(0, 255).astype(np.uint8)


def equalize_aug(img, rng, prob=0.5):
    """EqualizeTransform: per-channel histogram equalization."""
    if rng.rand() > prob:
        return img
    return np.stack([equalize_hist_u8(_u8(img[..., c])).numpy()
                     for c in range(3)], -1)


# The reference's detection policy set (auto_augment.py policies used by
# mmdet detection configs): per sample pick one sub-policy at random.
AUTOAUG_POLICIES_V0 = (
    (("translate", dict(level=8, direction="horizontal", prob=0.6)),
     ("rotate", dict(level=8, prob=0.6))),
    (("shear", dict(level=6, direction="vertical", prob=0.6)),
     ("brightness", dict(level=6, prob=0.6))),
    (("rotate", dict(level=10, prob=0.6)),
     ("color", dict(level=6, prob=0.6))),
    (("translate", dict(level=8, direction="vertical", prob=0.6)),
     ("equalize", dict(prob=0.8)),),
    (("shear", dict(level=8, direction="horizontal", prob=0.6)),
     ("contrast", dict(level=6, prob=0.6))),
)


def auto_augment(img, boxes, labels, rng: np.random.RandomState,
                 policies=AUTOAUG_POLICIES_V0):
    """Apply one randomly chosen sub-policy (mmdet AutoAugment.__call__:
    ``np.random.choice(policies)`` then sequential ops)."""
    policy = policies[rng.randint(len(policies))]
    for name, kw in policy:
        if name == "shear":
            img, boxes, labels = shear_aug(img, boxes, labels, rng, **kw)
        elif name == "rotate":
            img, boxes, labels = rotate_aug(img, boxes, labels, rng, **kw)
        elif name == "translate":
            img, boxes, labels = translate_aug(
                img, boxes, labels, rng, **kw)
        elif name == "color":
            img = color_aug(img, rng, **kw)
        elif name == "brightness":
            img = brightness_aug(img, rng, **kw)
        elif name == "contrast":
            img = contrast_aug(img, rng, **kw)
        elif name == "equalize":
            img = equalize_aug(img, rng, **kw)
        else:
            raise ValueError(f"unknown autoaugment op {name!r}")
    return img, boxes, labels


class Albu:
    """Albumentations bridge (mmdet ``Albu`` analog, transforms.py:1320).

    Builds an albumentations ``Compose`` from dict specs
    (``{"type": name_or_class, **kwargs}``; nested ``transforms`` lists
    build recursively, so ``OneOf`` etc. work) and applies it to the
    functional ``(img, boxes xyxy, labels)`` triple this data layer
    uses.  Labels stay in sync when transforms drop boxes via the
    reference's idx_mapper filtration trick (transforms.py:1466-1494).

    Gated on the package: raises ImportError with install guidance when
    albumentations is missing (neither the CPU test machine nor the GPU
    machine has it; ``tests/test_torch_albu.py`` runs the bridge through
    a minimal protocol shim and the gate directly).
    """

    def __init__(self, transforms: Sequence[dict],
                 bbox_params: Optional[dict] = None):
        try:
            import albumentations
        except ImportError as e:
            raise ImportError(
                "the Albu bridge (mmdet transforms.py:1320 analog) needs "
                "the optional albumentations package: pip install "
                "albumentations") from e
        self._A = albumentations
        bp = dict(format="pascal_voc", label_fields=["idx_mapper"])
        if bbox_params:
            bp.update(bbox_params)
            bp["label_fields"] = ["idx_mapper"]  # labels ride the mapper
            bp.pop("filter_lost_elements", None)
        self.aug = albumentations.Compose(
            [self._build(t) for t in transforms],
            bbox_params=albumentations.BboxParams(**bp))

    def _build(self, cfg: dict):
        args = dict(cfg)
        obj_type = args.pop("type")
        cls = (getattr(self._A, obj_type) if isinstance(obj_type, str)
               else obj_type)
        if "transforms" in args:
            args["transforms"] = [self._build(t)
                                  for t in args["transforms"]]
        return cls(**args)

    def __call__(self, img: np.ndarray, boxes: np.ndarray,
                 labels: np.ndarray):
        res = self.aug(image=img,
                       bboxes=[tuple(map(float, b)) for b in boxes],
                       idx_mapper=list(range(len(boxes))))
        keep = np.asarray(res["idx_mapper"], np.int64)
        out_boxes = np.asarray(res["bboxes"],
                               np.float32).reshape(-1, 4)
        out_labels = (np.asarray(labels)[keep] if len(keep)
                      else np.zeros((0,), np.int64))
        return res["image"], out_boxes, out_labels
