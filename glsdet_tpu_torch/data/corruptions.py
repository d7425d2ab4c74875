"""Image corruption benchmark transforms (robustness eval), the port's
copy of ``glsdet_tpu/data/corruptions.py``.

Behavioral reference: ``yolox-ufp/tools/analysis_tools/test_robustness.py``
+ ``robustness_eval.py`` — mmdet's COCO-C style benchmark applies the
ImageNet-C corruption set at severities 1-5 and reports per-corruption AP
plus mPC/rPC aggregates.  The JAX package implements a self-contained
subset following the ImageNet-C definitions (Hendrycks & Dietterich,
2019): three noise types, two blurs, brightness/contrast, and the two
digital corruptions.  Corruptions are deterministic given (severity,
seed) so benchmark runs reproduce.

The numpy corruptions are carried over line for line: the same
``RandomState`` draws in the same order give the same bytes.  The
OpenCV calls, which the GPU machine lacks, are torch twins in
``ops/image.py`` (``filter2d_u8``, ``rotation_matrix_2d``,
``warp_affine_f32``, ``resize_area_u8``, ``resize_nearest_u8``) that run
on the CPU, as the loader's ``resize_linear_u8`` and ``warp_affine_u8``
do; the JPEG round trip is ``data/image_io.py``'s codec,
which writes ``cv2.imencode``'s bytes at every quality.
``tests/test_torch_corruptions.py`` states per corruption what equals
the JAX module's output: every corruption is bit-equal except
``motion_blur`` at sizes 13-21, whose kernels OpenCV may correlate
through a DFT (within one code, in a small share of the values).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from glsdet_tpu_torch.data.image_io import decode_jpeg, encode_jpeg
from glsdet_tpu_torch.ops.image import (filter2d_u8, resize_area_u8,
                                        resize_nearest_u8,
                                        rotation_matrix_2d, warp_affine_f32)

__all__ = ["CORRUPTIONS", "BENCHMARK_CORRUPTIONS", "corrupt",
           "CorruptedDataset"]


def _to_float(img):
    return np.asarray(img, np.float32) / 255.0


def _to_uint8(x):
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def gaussian_noise(img, severity, rng):
    c = [0.08, 0.12, 0.18, 0.26, 0.38][severity - 1]
    x = _to_float(img)
    return _to_uint8(x + rng.normal(size=x.shape) * c)


def shot_noise(img, severity, rng):
    c = [60, 25, 12, 5, 3][severity - 1]
    x = _to_float(img)
    return _to_uint8(rng.poisson(x * c) / float(c))


def impulse_noise(img, severity, rng):
    amount = [0.03, 0.06, 0.09, 0.17, 0.27][severity - 1]
    x = _to_float(img).copy()
    flipped = rng.rand(*x.shape[:2]) < amount
    salt = rng.rand(*x.shape[:2]) < 0.5
    x[flipped & salt] = 1.0
    x[flipped & ~salt] = 0.0
    return _to_uint8(x)


def _disk_kernel(radius):
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    k = (x * x + y * y <= radius * radius).astype(np.float32)
    return k / k.sum()


def _filter(img, kernel):
    return filter2d_u8(torch.from_numpy(img), kernel).numpy()


def defocus_blur(img, severity, rng):
    radius = [3, 4, 6, 8, 10][severity - 1]
    return _filter(img, _disk_kernel(radius))


def _motion_kernel(size):
    k = np.zeros((size, size), np.float32)
    k[size // 2, :] = 1.0
    rot = rotation_matrix_2d((size / 2 - 0.5, size / 2 - 0.5), 45.0, 1.0)
    return warp_affine_f32(torch.from_numpy(k), rot, (size, size)).numpy()


def motion_blur(img, severity, rng):
    size = [9, 13, 15, 17, 21][severity - 1]
    k = _motion_kernel(size)
    return _filter(img, k / k.sum())


def brightness(img, severity, rng):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    return _to_uint8(_to_float(img) + c)


def contrast(img, severity, rng):
    c = [0.4, 0.3, 0.2, 0.1, 0.05][severity - 1]
    x = _to_float(img)
    mean = x.mean(axis=(0, 1), keepdims=True)
    return _to_uint8((x - mean) * c + mean)


def jpeg_compression(img, severity, rng):
    q = [25, 18, 15, 10, 7][severity - 1]
    return decode_jpeg(encode_jpeg(img, q))


def pixelate(img, severity, rng):
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    h, w = img.shape[:2]
    small = resize_area_u8(torch.from_numpy(img),
                           (max(1, int(h * c)), max(1, int(w * c))))
    return resize_nearest_u8(small, (h, w)).numpy()


CORRUPTIONS = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "defocus_blur": defocus_blur,
    "motion_blur": motion_blur,
    "brightness": brightness,
    "contrast": contrast,
    "jpeg_compression": jpeg_compression,
    "pixelate": pixelate,
}
# the sweep tools/test_robustness.py runs by default
BENCHMARK_CORRUPTIONS = tuple(CORRUPTIONS)


def corrupt(img: np.ndarray, name: str, severity: int,
            seed: Optional[int] = None) -> np.ndarray:
    """Apply one corruption at severity 1-5 to a uint8 RGB image."""
    if severity == 0:
        return img
    if not 1 <= severity <= 5:
        raise ValueError(f"severity must be in [0, 5], got {severity}")
    fn = CORRUPTIONS[name]
    rng = np.random.RandomState(
        0 if seed is None else seed & 0x7FFFFFFF)
    out = fn(np.ascontiguousarray(img), int(severity), rng)
    return np.ascontiguousarray(out)


class CorruptedDataset:
    """Dataset proxy applying one (corruption, severity) to every image.

    Deterministic: the noise RNG is seeded per image id, so a benchmark
    cell is reproducible across runs and processes."""

    def __init__(self, dataset, name: str, severity: int):
        self._ds = dataset
        self.name = name
        self.severity = int(severity)

    def __getattr__(self, attr):
        return getattr(self._ds, attr)

    def __len__(self):
        return len(self._ds)

    def load_image(self, rec) -> np.ndarray:
        img = self._ds.load_image(rec)
        return corrupt(img, self.name, self.severity,
                       seed=int(rec.img_id) * 1000 + self.severity)
