"""Image resizes and warps of the port: ``cv2.resize`` on uint8 frames
(:func:`resize_linear_u8`), ``cv2.warpAffine`` on uint8 frames
(:func:`warp_affine_u8`) and ``jax.image.resize(..., "bilinear")`` on
float batches (:func:`resize_bilinear`); the OpenCV calls of the
corruptions and the CAM tool (``cv2.filter2D``, ``getRotationMatrix2D``,
a float ``warpAffine``, INTER_AREA and INTER_NEAREST resizes of uint8
frames, INTER_LINEAR of float images); and the float preprocessing of
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


def _coords(src: int, dst: int, clamp_weights: bool):
    """Source indices (s, s + 1), clamped into the image, and the float32
    fraction ``f`` of each output position along one axis, as
    ``cv2.resize`` INTER_LINEAR computes them."""
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
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def _taps(src: int, dst: int, clamp_weights: bool):
    """:func:`_coords` with the fixed-point weights of uint8 images."""
    s0, s1, f = _coords(src, dst, clamp_weights)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(COEF_SCALE))
    w1 = np.rint(f * np.float32(COEF_SCALE))
    return s0, s1, w0.astype(np.int32), w1.astype(np.int32)


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
    out = _warp_linear(img, mat, out_hw, float(border_value))
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def warp_affine_f32(img: torch.Tensor, mat: np.ndarray,
                    out_hw: Tuple[int, int], border_value: float = 0.0
                    ) -> torch.Tensor:
    """(H, W) or (H, W, C) float32 -> (h, w[, C]) float32, as
    ``cv2.warpAffine(img, mat[:2], (w, h))`` (INTER_LINEAR, constant
    border ``border_value``) computes it: OpenCV 5.0's float kernel of
    :func:`warp_affine_u8` (the same coordinates, blocks and fused
    multiply-adds) without the final rounding.  ``data/corruptions.py``
    rotates its motion-blur kernel with it;
    ``tests/test_torch_corruptions.py`` holds it equal to
    ``cv2.warpAffine`` there."""
    if img.dtype != torch.float32 or img.dim() not in (2, 3):
        raise ValueError(f"expected an (H, W[, C]) float32 image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    out = _warp_linear(img if img.dim() == 3 else img[..., None], mat,
                       out_hw, float(border_value))
    return out if img.dim() == 3 else out[..., 0]


def _warp_linear(img: torch.Tensor, mat: np.ndarray, out_hw: Tuple[int, int],
                 border_value: float) -> torch.Tensor:
    """OpenCV 5.0's float warp of an (H, W, C) image, before the cast to
    the output type (:func:`warp_affine_u8`'s docstring)."""
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
        return torch.where(inside[..., None], v, border_value)

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    v0 = _fma(alpha, p01 - p00, p00)
    v1 = _fma(alpha, p11 - p10, p10)
    return _fma(beta, v1 - v0, v0)


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """The (2, 3) float64 matrix ``cv2.getRotationMatrix2D(center, angle,
    scale)`` returns: the centre taken as float32 (a ``Point2f``), the
    angle in degrees, counter-clockwise."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = angle * np.pi / 180
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _reflect101(n: int, lo: int, hi: int) -> np.ndarray:
    """Indices of positions -lo .. n + hi - 1 of an axis of length ``n``
    under OpenCV's BORDER_REFLECT_101 (``cv::borderInterpolate``)."""
    out = []
    for p in range(-lo, n + hi):
        if n == 1:
            p = 0
        while not 0 <= p < n:
            p = -p if p < 0 else 2 * n - p - 2
        out.append(p)
    return np.asarray(out, np.int64)


def filter2d_u8(img: torch.Tensor, kernel: np.ndarray,
                band: int = 64) -> torch.Tensor:
    """(H, W, C) uint8 -> (H, W, C) uint8, as ``cv2.filter2D(img, -1,
    kernel)`` computes it for a float32 kernel (anchor at its centre,
    BORDER_REFLECT_101), on ``img``'s device.

    OpenCV correlates directly in float32: the kernel's nonzero taps in
    row-major order, each a fused multiply-add into the running sum
    (``FilterVec_8u``'s ``v_muladd``), then rounds half to even and
    saturates.  The fused multiply-add is a float64 product (exact for a
    float32 tap and a byte) and sum rounded to float32.  For kernels of
    130 taps and more (13x13 up) OpenCV may take a DFT instead, whose
    float error moves results that lie within ~1e-5 of a half:
    ``tests/test_torch_corruptions.py`` states per kernel what holds.

    The chain runs over bands of ``band`` rows, each band through every
    tap, so that a band's sums stay in cache (2-3x faster on a CPU for
    the large disks; the same values)."""
    if img.dtype != torch.uint8 or img.dim() != 3:
        raise ValueError(f"expected an (H, W, C) uint8 image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    k = np.asarray(kernel, np.float32)
    kh, kw = k.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape[:2]
    dev = img.device
    rows = torch.from_numpy(_reflect101(h, ay, kh - 1 - ay)).to(dev)
    cols = torch.from_numpy(_reflect101(w, ax, kw - 1 - ax)).to(dev)
    src = img[rows][:, cols].to(torch.float32)
    taps = [(int(i), int(j), float(k[i, j])) for i, j in np.argwhere(k != 0)]
    out = torch.zeros((h, w, img.shape[2]), dtype=torch.float32, device=dev)
    for r0 in range(0, h, band):
        r1 = min(h, r0 + band)
        acc = out[r0:r1]
        wide = torch.empty(acc.shape, dtype=torch.float64, device=dev)
        for i, j, kij in taps:
            wide.copy_(acc).add_(src[r0 + i:r1 + i, j:j + w], alpha=kij)
            acc.copy_(wide)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def _area_table(src: int, dst: int):
    """OpenCV's ``computeResizeAreaTab`` along one axis as dense (dst, T)
    source indices and float32 weights, in its order; unused taps weigh
    0 (adding ``0 * x`` changes no sum)."""
    scale = 1.0 / (dst / src)
    taps = [[] for _ in range(dst)]
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            taps[d].append((s1 - 1, (s1 - f1) / cell))
        taps[d] += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps[d].append((s2, min(min(f2 - s2, 1.0), cell) / cell))
    n = max(len(t) for t in taps)
    idx = np.zeros((dst, n), np.int64)
    wgt = np.zeros((dst, n), np.float32)
    for d, t in enumerate(taps):
        for c, (s, a) in enumerate(t):
            idx[d, c], wgt[d, c] = s, a
    return idx, wgt


def resize_area_u8(img: torch.Tensor, out_hw: Tuple[int, int]
                   ) -> torch.Tensor:
    """(H, W, C) uint8 -> (h, w, C) uint8 with h <= H and w <= W, as
    ``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` computes
    it, on ``img``'s device.

    - At integer factors (``H / h`` and ``W / w`` whole) OpenCV averages
      each block: ``(a + b + c + d + 2) >> 2`` at 2x2 (its vector path),
      else the integer sum times the float32 ``1 / area``, rounded half
      to even.
    - Otherwise each output pixel is the float32 sum, source row by
      source row, of the pixels under it weighted by the share of them
      it covers (``computeResizeAreaTab``): a horizontal pass per source
      row, products rounded and added in the table's order, then the
      rows weighted and added the same way; rounded half to even."""
    if img.dtype != torch.uint8 or img.dim() != 3:
        raise ValueError(f"expected an (H, W, C) uint8 image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    src_h, src_w = img.shape[:2]
    h, w = int(out_hw[0]), int(out_hw[1])
    if not (0 < h <= src_h and 0 < w <= src_w):
        raise ValueError(f"INTER_AREA shrinks: {(src_h, src_w)} -> {(h, w)}")
    dev = img.device
    sx, sy = 1.0 / (w / src_w), 1.0 / (h / src_h)
    ix, iy = int(round(sx)), int(round(sy))
    eps = np.finfo(np.float64).eps
    if abs(sx - ix) < eps and abs(sy - iy) < eps:
        blocks = img[:h * iy, :w * ix].to(torch.int32).reshape(
            h, iy, w, ix, -1).sum(dim=(1, 3))
        if ix == iy == 2:
            return ((blocks + 2) >> 2).to(torch.uint8)
        out = blocks.to(torch.float32) * np.float32(1.0 / (ix * iy))
        return torch.round(out).clamp(0, 255).to(torch.uint8)

    def axis(src, dst):
        i, a = _area_table(src, dst)
        return torch.from_numpy(i).to(dev), torch.from_numpy(a).to(dev)

    xi, xa = axis(src_w, w)
    yi, ya = axis(src_h, h)
    x = img.to(torch.float32)
    rows = torch.zeros((src_h, w, img.shape[2]), dtype=torch.float32,
                       device=dev)
    for t in range(xi.shape[1]):
        rows = rows + x[:, xi[:, t]] * xa[:, t, None]
    out = rows[yi[:, 0]] * ya[:, 0, None, None]
    for t in range(1, yi.shape[1]):
        out = out + rows[yi[:, t]] * ya[:, t, None, None]
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def resize_nearest_u8(img: torch.Tensor, out_hw: Tuple[int, int]
                      ) -> torch.Tensor:
    """(H, W, C) -> (h, w, C), as ``cv2.resize(img, (w, h),
    interpolation=cv2.INTER_NEAREST)`` picks: output x reads source
    ``min(floor(x * (1 / (w / W))), W - 1)`` in float64, likewise y
    (OpenCV's ``resizeNN``, not INTER_NEAREST_EXACT)."""
    src_h, src_w = img.shape[:2]
    h, w = int(out_hw[0]), int(out_hw[1])

    def pick(src, dst):
        i = np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64)
        return torch.from_numpy(np.minimum(i, src - 1)).to(img.device)

    return img[pick(src_h, h)][:, pick(src_w, w)]


def resize_linear_f32(img: torch.Tensor, out_hw: Tuple[int, int]
                      ) -> torch.Tensor:
    """(H, W) or (H, W, C) float32 -> (h, w[, C]) float32, as
    ``cv2.resize(img, (w, h))`` (INTER_LINEAR) computes a float image:
    :func:`resize_linear_u8`'s source coordinates with float32 weights
    ``1 - f`` and ``f`` (no fixed point), each pass's two products
    rounded and added (OpenCV's float resize has no fused multiply-add
    on this build's baseline)."""
    if img.dtype != torch.float32 or img.dim() not in (2, 3):
        raise ValueError(f"expected an (H, W[, C]) float32 image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    x = img if img.dim() == 3 else img[..., None]
    src_h, src_w = x.shape[:2]
    h, w = int(out_hw[0]), int(out_hw[1])
    dev = img.device

    def taps(src, dst, clamp_weights):
        s0, s1, f = _coords(src, dst, clamp_weights)
        return tuple(torch.from_numpy(a).to(dev) for a in (
            s0, s1, (np.float32(1.0) - f).astype(np.float32), f))

    x0, x1, a0, a1 = taps(src_w, w, True)
    y0, y1, b0, b1 = taps(src_h, h, False)
    rows = x[:, x0] * a0[:, None] + x[:, x1] * a1[:, None]
    out = rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]
    return out if img.dim() == 3 else out[..., 0]


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
