"""``glsdet_tpu_torch/data/corruptions.py`` against the JAX package's
``glsdet_tpu/data/corruptions.py``, and the OpenCV twins it runs
(``ops/image.py``) against OpenCV 5.0, the version the CPU tests run
with.

What holds, per corruption (the same seed and frame to both modules):

- ``gaussian_noise``, ``shot_noise``, ``impulse_noise``, ``brightness``,
  ``contrast``: bit-equal (the numpy code carried over, the same
  ``RandomState`` draws);
- ``jpeg_compression``: bit-equal (``encode_jpeg`` writes
  ``cv2.imencode``'s bytes at qualities 25, 18, 15, 10 and 7, and the
  decoder reads ``cv2.imdecode``'s pixels);
- ``pixelate``: bit-equal (INTER_AREA at the fractional factors and at
  OpenCV's integer-factor fast path, then INTER_NEAREST);
- ``defocus_blur``: bit-equal at every radius (3-10, kernels 7x7 to
  21x21): every disk has an odd number of equal taps, so its exact sums
  lie at least 1/(2 n) from a rounding tie and any float32 order rounds
  them alike;
- ``motion_blur``: bit-equal at size 9 (81 taps, OpenCV's direct
  correlation, which the twin repeats); at sizes 13-21 (169-441 taps,
  past OpenCV's 130-tap DFT threshold) within one code, in at most 1e-4
  of the values (values within ~1e-5 of a half round either way).

The twins alone: ``filter2d_u8`` bit-equal to ``cv2.filter2D`` for the
disks and the size-9 motion kernel; ``rotation_matrix_2d`` and
``warp_affine_f32`` bit-equal to ``getRotationMatrix2D`` +
``warpAffine`` of the float32 kernel images (sizes 9-21);
``resize_area_u8`` / ``resize_nearest_u8`` bit-equal to ``cv2.resize``
(INTER_AREA / INTER_NEAREST) on odd, even and integer-factor shapes;
``resize_linear_f32`` within 4e-7 of ``cv2.resize`` on float32 maps in
[0, 1] (OpenCV 5.0's float INTER_LINEAR computes its coordinates in an
order the twin does not repeat: a few ulps)."""

import cv2
import numpy as np
import pytest
import torch

import glsdet_tpu.data.corruptions as jc
import glsdet_tpu_torch.data.corruptions as pc
from glsdet_tpu_torch.data.image_io import decode_jpeg, encode_jpeg
from glsdet_tpu_torch.ops.image import (filter2d_u8, resize_area_u8,
                                        resize_linear_f32, resize_nearest_u8,
                                        rotation_matrix_2d, warp_affine_f32)

EXACT = ("gaussian_noise", "shot_noise", "impulse_noise", "defocus_blur",
         "brightness", "contrast", "jpeg_compression", "pixelate")


def _frame(seed, hw, smooth):
    img = np.random.RandomState(seed).randint(0, 256, (*hw, 3), np.uint8)
    return cv2.GaussianBlur(img, (0, 0), 2) if smooth else img


FRAMES = {"noise_61x97": _frame(0, (61, 97), False),
          "smooth_120x200": _frame(1, (120, 200), True),
          "smooth_96x128": _frame(2, (96, 128), True)}


@pytest.mark.parametrize("name", list(jc.CORRUPTIONS))
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_corruption_matches_jax(name, frame):
    img = FRAMES[frame]
    assert list(pc.CORRUPTIONS) == list(jc.CORRUPTIONS)
    assert pc.BENCHMARK_CORRUPTIONS == jc.BENCHMARK_CORRUPTIONS
    for sev in range(1, 6):
        want = jc.corrupt(img, name, sev, seed=1000 * sev + 7)
        got = pc.corrupt(img, name, sev, seed=1000 * sev + 7)
        assert got.dtype == np.uint8 and got.shape == img.shape
        if name in EXACT or sev == 1:
            np.testing.assert_array_equal(got, want, err_msg=f"sev {sev}")
        else:
            d = np.abs(got.astype(int) - want)
            assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (
                sev, d.max(), (d > 0).mean())


def test_severity_zero_and_range():
    img = FRAMES["noise_61x97"]
    assert pc.corrupt(img, "contrast", 0) is img
    for bad in (-1, 6):
        with pytest.raises(ValueError, match="severity"):
            pc.corrupt(img, "contrast", bad)


class _Rec:
    def __init__(self, img_id):
        self.img_id = img_id


class _Dataset:
    records = [_Rec(3), _Rec(5)]
    class_names = ["a"]

    def __len__(self):
        return 2

    def load_image(self, rec):
        return FRAMES["smooth_96x128"]


@pytest.mark.parametrize("name", ["shot_noise", "pixelate"])
def test_corrupted_dataset_matches_jax(name):
    """The proxy seeds each image by its id and severity, as JAX's, and
    forwards everything else to the dataset."""
    got = pc.CorruptedDataset(_Dataset(), name, 4)
    want = jc.CorruptedDataset(_Dataset(), name, 4)
    assert len(got) == 2 and got.class_names == ["a"]
    for rec in _Dataset.records:
        np.testing.assert_array_equal(got.load_image(rec),
                                      want.load_image(rec))


@pytest.mark.parametrize("q", [25, 18, 15, 10, 7])
def test_jpeg_quality_bytes_equal_opencv(q):
    for img in FRAMES.values():
        ok, buf = cv2.imencode(".jpg", img[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, q])
        assert ok and encode_jpeg(img, q) == bytes(buf)
        np.testing.assert_array_equal(
            decode_jpeg(bytes(buf)),
            cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("size", [9, 13, 15, 17, 21])
def test_motion_kernel_equals_opencv(size):
    k = np.zeros((size, size), np.float32)
    k[size // 2, :] = 1.0
    center = (size / 2 - 0.5, size / 2 - 0.5)
    rot = cv2.getRotationMatrix2D(center, 45.0, 1.0)
    mine = rotation_matrix_2d(center, 45.0, 1.0)
    np.testing.assert_array_equal(mine, rot)
    np.testing.assert_array_equal(
        warp_affine_f32(torch.from_numpy(k), mine, (size, size)).numpy(),
        cv2.warpAffine(k, rot, (size, size)))


@pytest.mark.parametrize("kernel", ["disk3", "disk4", "disk6", "disk8",
                                    "disk10", "motion9"])
def test_filter2d_equals_opencv(kernel):
    if kernel.startswith("disk"):
        k = jc._disk_kernel(int(kernel[4:]))
    else:
        k = pc._motion_kernel(9)
        k = k / k.sum()
    for img in FRAMES.values():
        np.testing.assert_array_equal(
            filter2d_u8(torch.from_numpy(img), k).numpy(),
            cv2.filter2D(img, -1, k))
    tiny = FRAMES["noise_61x97"][:5, :7]     # reflected more than once
    np.testing.assert_array_equal(filter2d_u8(torch.from_numpy(tiny),
                                              k).numpy(),
                                  cv2.filter2D(tiny, -1, k))


@pytest.mark.parametrize("hw", [(61, 97), (64, 96), (48, 64), (7, 5),
                                (120, 200)])
def test_area_and_nearest_resize_equal_opencv(hw):
    img = np.random.RandomState(hw[0]).randint(0, 256, (*hw, 3), np.uint8)
    sizes = {(max(1, int(hw[0] * c)), max(1, int(hw[1] * c)))
             for c in (0.6, 0.5, 0.4, 0.3, 0.25)} | {(hw[0] // 3 or 1,
                                                      hw[1] // 3 or 1)}
    for h, w in sorted(sizes):
        small = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(
            resize_area_u8(torch.from_numpy(img), (h, w)).numpy(), small,
            err_msg=str((h, w)))
        np.testing.assert_array_equal(
            resize_nearest_u8(torch.from_numpy(small), hw).numpy(),
            cv2.resize(small, (hw[1], hw[0]),
                       interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("shapes", [((2, 2), (64, 64)), ((8, 8), (765, 1360)),
                                    ((5, 7), (97, 61)), ((20, 20), (64, 64))])
def test_linear_float_resize_within_ulps_of_opencv(shapes):
    (sh, sw), (h, w) = shapes
    x = np.random.RandomState(sh * sw).rand(sh, sw).astype(np.float32)
    got = resize_linear_f32(torch.from_numpy(x), (h, w)).numpy()
    np.testing.assert_allclose(got, cv2.resize(x, (w, h)), rtol=0,
                               atol=4e-7)
