"""Image resizes and warps of the port: ``cv2.resize`` on uint8 frames
(:func:`resize_linear_u8`), ``cv2.warpAffine`` on uint8 frames
(:func:`warp_affine_u8`) and ``jax.image.resize(..., "bilinear")`` on
float batches (:func:`resize_bilinear`); and the float preprocessing of
``glsdet_tpu.ops.image`` built on the last: :func:`normalize_image`,
:func:`resize_keep_ratio`, :func:`letterbox` (pad 128, float canvas; not
``data/augment.py: letterbox``, pad 114 on uint8 with ``cv2.resize``)
and :func:`unletterbox_boxes`.

``cv2.resize(img, (w, h))`` (INTER_LINEAR on uint8) in integer torch ops.

``apis.Detector`` resizes every frame as the JAX package's does, with
OpenCV; the GPU machine has no OpenCV, so this module repeats its
fixed-point arithmetic on the frame's device:

- per output column and row, OpenCV's float32 source coordinate
  ``f = (d + 0.5) * scale - 0.5``, its floor ``s`` and the two tap
  weights ``round((1 - (f - s)) * 2048)`` and ``round((f - s) * 2048)``
  (columns clamp ``f`` to the edge pixel, rows only clamp the row index);
- the horizontal pass in int32, ``S[s] * a0 + S[s + 1] * a1``;
- the vertical pass as OpenCV's SIMD kernel computes it,
  ``(((b0 * (H0 >> 4)) >> 16) + ((b1 * (H1 >> 4)) >> 16) + 2) >> 2``,
  saturated to uint8;
- an exact 2x reduction in both axes is OpenCV's area average
  ``(a + b + c + d + 2) >> 2``, as ``cv2.resize`` switches to it.

``tests/test_torch_apis.py`` holds it equal to ``cv2.resize`` value for
value at downscales (765x1360 -> 640x640, 96x160 -> 64x64), an upscale,
a mixed one, the 2x reduction and the identity.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from glsdet_tpu_torch.data.coco import IMAGENET_MEAN, IMAGENET_STD

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


def _taps(src: int, dst: int, clamp_weights: bool):
    """Source indices (s, s + 1), clamped into the image, and the
    fixed-point weights of each output position along one axis."""
    scale = 1.0 / (dst / src)             # OpenCV: 1 / inv_scale
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0.0
        s[lo] = 0
        s[hi] = src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(COEF_SCALE))
    w1 = np.rint(f * np.float32(COEF_SCALE))
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
            w0.astype(np.int32), w1.astype(np.int32))


def resize_linear_u8(img: torch.Tensor, out_hw: Tuple[int, int]
                     ) -> torch.Tensor:
    """(H, W, C) uint8 -> (h, w, C) uint8, as ``cv2.resize(img, (w, h))``
    computes it (module docstring), on ``img``'s device."""
    if img.dtype != torch.uint8 or img.dim() != 3:
        raise ValueError(f"expected an (H, W, C) uint8 image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    src_h, src_w = img.shape[:2]
    h, w = int(out_hw[0]), int(out_hw[1])
    x = img.to(torch.int32)
    if src_h == 2 * h and src_w == 2 * w:
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2]
                 + x[1::2, 1::2] + 2) >> 2).to(torch.uint8)
    dev = img.device

    def put(a):
        return torch.from_numpy(a).to(dev)

    x0, x1, a0, a1 = (put(a) for a in _taps(src_w, w, True))
    y0, y1, b0, b1 = (put(a) for a in _taps(src_h, h, False))

    def horizontal(rows):
        return rows[:, x0] * a0[:, None] + rows[:, x1] * a1[:, None]

    h0 = horizontal(x[y0]) >> 4
    h1 = horizontal(x[y1]) >> 4
    out = (((b0[:, None, None] * h0) >> 16)
           + ((b1[:, None, None] * h1) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


# output columns per vector block of OpenCV's float warp kernel for 8UC3
# (an AVX2 build); the columns past the last full block take its scalar
# tail, whose coordinate is summed in another order
WARP_BLOCK = 16


def _affine_inverse(mat: np.ndarray) -> Tuple[float, ...]:
    """The output -> source map of a (2, 3) forward matrix, as
    ``cv2.warpAffine`` inverts it (in double, in OpenCV's order)."""
    m = [float(v) for v in np.asarray(mat, np.float64)[:2].reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return tuple(m)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return (a.double() * b + c.double()).float()


def warp_affine_u8(img: torch.Tensor, mat: np.ndarray,
                   out_hw: Tuple[int, int], border_value: int = 114
                   ) -> torch.Tensor:
    """(H, W, C) uint8 -> (h, w, C) uint8, as ``cv2.warpAffine(img,
    mat[:2], (w, h), borderValue=(border_value,) * 3)`` (INTER_LINEAR,
    constant border) computes it, on ``img``'s device.

    OpenCV 4.11 replaced the fixed-point remap (``AB_BITS = 10``
    coordinates, 5-bit sub-pixel tables, 15-bit weights) with float32
    kernels, and the OpenCV these tests hold the port to (5.0) runs
    them; the fixed-point arithmetic differs from it by up to 6 codes in
    60% of pixels.  This repeats the float kernel:

    - the forward matrix inverted in double as OpenCV does, then cast to
      float32 (M0..M5);
    - per pixel ``sx = fma(x, M0, y * M1 + M2)`` and ``sy = fma(x, M3,
      y * M4 + M5)`` in blocks of ``WARP_BLOCK`` columns, and ``fma(x,
      M0, y * M1) + M2`` in the scalar tail past the last block;
    - ``ix = floor(sx)``, ``alpha = sx - ix`` (likewise y, ``beta``);
      taps outside the image read ``border_value``;
    - ``v0 = fma(alpha, p01 - p00, p00)``, ``v1 = fma(alpha, p11 - p10,
      p10)``, ``fma(beta, v1 - v0, v0)``, rounded half to even and
      saturated.

    The fused multiply-adds are float64 products rounded to float32
    once.  ``tests/test_torch_augment.py`` holds it equal to
    ``cv2.warpAffine`` value for value over the matrices
    ``random_affine_params`` draws, the identity, a pure scale and a
    flip, at widths with and without a tail."""
    if img.dtype != torch.uint8 or img.dim() != 3:
        raise ValueError(f"expected an (H, W, C) uint8 image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    src_h, src_w, ch = img.shape
    h, w = int(out_hw[0]), int(out_hw[1])
    m = [float(np.float32(v)) for v in _affine_inverse(mat)]
    dev = img.device
    f32 = torch.float32
    xs = torch.arange(w, dtype=f32, device=dev)[None, :]
    ys = torch.arange(h, dtype=f32, device=dev)[:, None]
    tail = w - w % WARP_BLOCK

    def coord(mx, my, mc):
        row = (ys * np.float32(my)).to(f32) + np.float32(mc)
        out = _fma(xs.expand(h, w), mx, row.expand(h, w))
        if tail < w:
            out[:, tail:] = _fma(xs[:, tail:].expand(h, w - tail), mx,
                                 (ys * np.float32(my)).expand(
                                     h, w - tail)) + np.float32(mc)
        return out

    sx = coord(m[0], m[1], m[2])
    sy = coord(m[3], m[4], m[5])
    fx, fy = torch.floor(sx), torch.floor(sy)
    alpha = (sx - fx)[..., None]
    beta = (sy - fy)[..., None]
    ix, iy = fx.to(torch.int64), fy.to(torch.int64)
    flat = img.reshape(-1, ch)

    def tap(ty, tx):
        inside = (ty >= 0) & (ty < src_h) & (tx >= 0) & (tx < src_w)
        idx = (ty.clamp(0, src_h - 1) * src_w
               + tx.clamp(0, src_w - 1)).reshape(-1)
        v = flat.index_select(0, idx).reshape(h, w, ch).to(f32)
        return torch.where(inside[..., None], v, float(border_value))

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    v0 = _fma(alpha, p01 - p00, p00)
    v1 = _fma(alpha, p11 - p10, p10)
    out = _fma(beta, v1 - v0, v0)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


_F32 = np.float32
_weights: Dict[tuple, torch.Tensor] = {}


def bilinear_weights(src: int, dst: int) -> np.ndarray:
    """(src, dst) float32 weights of ``jax.image.resize``'s "bilinear"
    along one axis (``scale_and_translate``'s ``compute_weight_mat``,
    antialiased): the triangle kernel widened by ``src / dst`` when it
    shrinks, each column renormalised to sum 1 (so the borders, where
    taps fall outside, are not darkened), every step in float32 as JAX
    computes it."""
    inv_scale = _F32(1.0 / (dst / src))
    kernel_scale = max(inv_scale, _F32(1.0))
    sample = ((np.arange(dst, dtype=_F32) + _F32(0.5)) * inv_scale
              - _F32(0.5))
    x = np.abs(sample[None, :] - np.arange(src, dtype=_F32)[:, None]) \
        / kernel_scale
    w = np.maximum(_F32(0.0), _F32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=_F32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, _F32(1.0)), _F32(0.0))
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[None, :], w, _F32(0.0)).astype(_F32)


def _weight(src: int, dst: int, device) -> torch.Tensor:
    """:func:`bilinear_weights` on ``device``, made once per (src, dst,
    device) and kept: a later resize copies nothing to the card."""
    key = (src, dst, torch.device(device))
    if key not in _weights:
        _weights[key] = torch.from_numpy(bilinear_weights(src, dst)).to(
            key[2])
    return _weights[key]


def resize_bilinear(images: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """(B, H, W, C) float -> (B, h, w, C), as ``jax.image.resize(images,
    (B, h, w, C), "bilinear")``: one weight matrix per resized axis, each
    applied as a matrix product (an axis whose size is kept is left as it
    is, as JAX skips it)."""
    h, w = int(out_hw[0]), int(out_hw[1])
    x = images
    if x.shape[1] != h:
        x = torch.einsum("bhwc,hk->bkwc", x,
                         _weight(x.shape[1], h, x.device).to(x.dtype))
    if x.shape[2] != w:
        x = torch.einsum("bhwc,wk->bhkc", x,
                         _weight(x.shape[2], w, x.device).to(x.dtype))
    return x


def normalize_image(img: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., H, W, 3) uint8 or float -> ``(x - mean) / std`` in float32,
    cast to ``dtype`` (NHWC).  Divides by a float32 tensor, as the JAX
    package does (a division by a Python scalar becomes a multiplication
    by its reciprocal on CUDA)."""
    dev = img.device
    m = torch.as_tensor(mean, dtype=torch.float32).to(dev)
    sd = torch.as_tensor(std, dtype=torch.float32).to(dev)
    return ((img.float() - m) / sd).to(dtype)


def _keep_ratio_resize(img: torch.Tensor, out_h: int, out_w: int,
                       method: str):
    """The keep-aspect resize of an (H, W, C) image in float32 as
    ``jax.image.resize`` does it, and its scale."""
    if method not in ("bilinear", "linear"):
        raise NotImplementedError(f"method {method!r}: the port resizes "
                                  "with 'bilinear' only")
    h, w = img.shape[0], img.shape[1]
    scale = min(out_h / h, out_w / w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    resized = resize_bilinear(img.float()[None], (new_h, new_w))[0]
    return resized, scale


def resize_keep_ratio(img: torch.Tensor, out_h: int, out_w: int,
                      method: str = "bilinear"):
    """Keep-aspect resize into an (out_h, out_w) float32 canvas, top-left
    anchored and zero padded (mmdet ``Resize(keep_ratio=True)`` +
    ``Pad``).  Returns (canvas, scale), ``scale`` mapping original
    coordinates to canvas ones."""
    resized, scale = _keep_ratio_resize(img, out_h, out_w, method)
    canvas = torch.zeros((out_h, out_w, img.shape[2]), dtype=torch.float32,
                         device=img.device)
    canvas[:resized.shape[0], :resized.shape[1]] = resized
    return canvas, scale


def letterbox(img: torch.Tensor, out_h: int, out_w: int,
              pad_value: float = 128.0, method: str = "bilinear"):
    """Centre-padded keep-aspect resize into a float32 canvas
    (yolox-drone ``resize_image`` with ``letterbox_image=True``).  Returns
    (canvas, scale, (pad_x, pad_y))."""
    resized, scale = _keep_ratio_resize(img, out_h, out_w, method)
    new_h, new_w = resized.shape[0], resized.shape[1]
    pad_y, pad_x = (out_h - new_h) // 2, (out_w - new_w) // 2
    canvas = torch.full((out_h, out_w, img.shape[2]), float(pad_value),
                        dtype=torch.float32, device=img.device)
    canvas[pad_y:pad_y + new_h, pad_x:pad_x + new_w] = resized
    return canvas, scale, (pad_x, pad_y)


def unletterbox_boxes(boxes: torch.Tensor, scale: float, pad_x: float,
                      pad_y: float) -> torch.Tensor:
    """xyxy boxes from letterboxed-canvas coordinates back to the original
    image (yolox-drone ``yolo_correct_boxes``)."""
    shift = torch.tensor([pad_x, pad_y, pad_x, pad_y], dtype=boxes.dtype,
                         device=boxes.device)
    return (boxes - shift) / torch.tensor(scale, dtype=boxes.dtype,
                                          device=boxes.device)
