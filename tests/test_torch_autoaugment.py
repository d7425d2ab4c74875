"""The rest of the port's data layer against OpenCV and the JAX package:
``random_crop``, ``photometric_distortion``, the AutoAugment family
(shear, rotate, translate, colour, brightness, contrast, equalize,
``auto_augment``) and the two OpenCV twins they add to ``ops/image.py``.

Every comparison is bit for bit (tolerance 0): pixels ``array_equal``,
boxes and labels equal in value and dtype, after the same
``RandomState`` draws on both sides, which then must stand at the same
place (the next draw agrees):

- ``rgb_to_gray_u8`` equals ``cv2.cvtColor(RGB2GRAY)`` over every RGB
  triple, at widths with and without a vector tail;
- ``equalize_hist_u8`` equals ``cv2.equalizeHist``, single-valued and
  two-valued images included;
- each augmentation equals ``glsdet_tpu.data.augment``'s at odd widths
  and at 765x1360: levels 0-10 at ``prob=1.0``, both directions, with
  and without ``random_negative``, the drawn probabilities, 16 seeds of
  ``auto_augment`` and of ``photometric_distortion``;
- ``warp_affine_u8`` casts a fractional border value as OpenCV does
  (rounded, not truncated);
- the digests of ``chip_smoke.py``'s ``data_forms`` phase, recomputed
  from the JAX package.
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

from glsdet_tpu.data import augment as jaug
from glsdet_tpu_torch.data import augment as taug
from glsdet_tpu_torch.ops.image import (equalize_hist_u8, rgb_to_gray_u8,
                                        warp_affine_u8)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# odd widths, a width past OpenCV's 16-column warp blocks, the full frame
SHAPES = [(37, 53), (61, 45), (64, 97), (765, 1360)]
SMALL = SHAPES[:3]


def frame(shape, seed=0):
    return np.random.RandomState(seed + shape[1]).randint(
        0, 256, (*shape, 3), np.uint8)


def gts(shape, seed=0, n=8):
    rs = np.random.RandomState(seed + shape[0])
    h, w = shape
    x1, y1 = rs.uniform(0, w - 8, n), rs.uniform(0, h - 8, n)
    boxes = np.stack([x1, y1, x1 + rs.uniform(2, w / 3, n),
                      y1 + rs.uniform(2, h / 3, n)], 1).astype(np.float32)
    return boxes, rs.randint(0, 10, n).astype(np.int32)


def assert_same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def both(fn_name, seed, *args, **kw):
    """Run the JAX and the port function on twin RandomStates; assert
    equal outputs and the streams at the same place."""
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    want = getattr(jaug, fn_name)(*args, rng=r1, **kw)
    got = getattr(taug, fn_name)(*args, rng=r2, **kw)
    assert_same(got, want)
    assert r1.rand() == r2.rand()
    return got


@pytest.mark.parametrize("width", [8192, 8191, 47])
def test_rgb_to_gray_equals_cv2_over_every_triple(width):
    cube = np.stack(np.meshgrid(np.arange(256), np.arange(256),
                                np.arange(256), indexing="ij"), -1)
    cube = cube.reshape(-1, 3).astype(np.uint8)
    n = len(cube) // width * width
    img = np.ascontiguousarray(cube[:n].reshape(-1, width, 3))
    np.testing.assert_array_equal(rgb_to_gray_u8(torch.from_numpy(img)).numpy(),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


def _hist_cases():
    rs = np.random.RandomState(3)
    return {
        "uniform": rs.randint(0, 256, (37, 53), np.uint8),
        "full_frame": rs.randint(90, 120, (765, 1360)).astype(np.uint8),
        "skewed": (rs.beta(2, 5, (64, 80)) * 255).astype(np.uint8),
        "single_0": np.zeros((5, 7), np.uint8),
        "single_77": np.full((9, 3), 77, np.uint8),
        "single_255": np.full((4, 4), 255, np.uint8),
        "two_valued": np.where(rs.rand(9, 11) < 0.3, 10, 200).astype(np.uint8),
        "two_extremes": np.array([[0, 255, 255]], np.uint8),
        "one_pixel": np.array([[5]], np.uint8),
        "narrow": rs.randint(250, 256, (13, 17)).astype(np.uint8),
    }


@pytest.mark.parametrize("case", sorted(_hist_cases()))
def test_equalize_hist_equals_cv2(case):
    img = _hist_cases()[case]
    np.testing.assert_array_equal(
        equalize_hist_u8(torch.from_numpy(img)).numpy(), cv2.equalizeHist(img))


@pytest.mark.parametrize("shape", SHAPES)
def test_random_crop_equals_jax(shape):
    img = frame(shape)
    boxes, labels = gts(shape)
    for seed in range(6):
        for crop in [(shape[0] // 2 + 1, shape[1] // 2 + 3),
                     (shape[0] + 5, shape[1] // 3), shape]:
            out = both("random_crop", seed, img, boxes, labels,
                       crop_hw=crop)
            assert out[0].shape[:2] == (min(crop[0], shape[0]),
                                        min(crop[1], shape[1]))
    both("random_crop", 0, img, boxes[:0], labels[:0], crop_hw=(9, 9))


@pytest.mark.parametrize("seed", range(16))
def test_photometric_distortion_equals_jax(seed):
    shape = SMALL[seed % len(SMALL)]
    both("photometric_distortion", seed, frame(shape, seed))


def test_photometric_distortion_full_frame_equals_jax():
    img = frame(SHAPES[-1])
    for seed in (0, 5):
        both("photometric_distortion", seed, img, brightness_delta=40,
             hue_delta=30)


@pytest.mark.parametrize("neg", [True, False])
@pytest.mark.parametrize("direction", ["horizontal", "vertical"])
@pytest.mark.parametrize("op", ["shear_aug", "translate_aug"])
def test_directional_levels_equal_jax(op, direction, neg):
    for shape in SMALL:
        img = frame(shape)
        boxes, labels = gts(shape)
        for level in range(11):
            both(op, level, img, boxes, labels, level=level,
                 direction=direction, prob=1.0, random_negative=neg)


@pytest.mark.parametrize("neg", [True, False])
def test_rotate_levels_equal_jax(neg):
    for shape in SMALL:
        img = frame(shape)
        boxes, labels = gts(shape)
        for level in range(11):
            both("rotate_aug", level, img, boxes, labels, level=level,
                 prob=1.0, random_negative=neg)


@pytest.mark.parametrize("op", ["color_aug", "brightness_aug",
                                "contrast_aug"])
def test_photometric_levels_equal_jax(op):
    for shape in SMALL:
        img = frame(shape)
        for level in range(11):
            both(op, level, img, level=level, prob=1.0)


def test_contrast_blend_runs_in_float64_as_jax():
    """The grey mean is a numpy float64 scalar; NumPy 2 promotes the
    float32 blend to float64 with it, and the port keeps that."""
    img = frame(SMALL[0], 4)
    mean = rgb_to_gray_u8(torch.from_numpy(img)).numpy().mean()
    assert (img.astype(np.float32) * 0.6 + mean * 0.4).dtype == np.float64
    both("contrast_aug", 0, img, level=6, prob=1.0)


def test_equalize_equals_jax():
    for shape in SMALL:
        both("equalize_aug", 0, frame(shape), prob=1.0)
    both("equalize_aug", 0, np.full((9, 13, 3), 40, np.uint8), prob=1.0)


@pytest.mark.parametrize("op", ["shear_aug", "rotate_aug", "translate_aug",
                                "color_aug", "brightness_aug",
                                "contrast_aug", "equalize_aug"])
def test_drawn_probabilities_equal_jax(op):
    """The default ``prob=0.5``: applied or passed through as the JAX
    function decides from the same draws."""
    shape = SMALL[1]
    img = frame(shape)
    boxes, labels = gts(shape)
    geometric = op in ("shear_aug", "rotate_aug", "translate_aug")
    for seed in range(12):
        args = (img, boxes, labels) if geometric else (img,)
        kw = {} if op == "equalize_aug" else {"level": 7}
        both(op, seed, *args, **kw)


@pytest.mark.parametrize("op", ["shear_aug", "rotate_aug", "translate_aug"])
def test_geometric_full_frame_equals_jax(op):
    shape = SHAPES[-1]
    img = frame(shape)
    boxes, labels = gts(shape, n=12)
    kw = {} if op == "rotate_aug" else {"direction": "vertical"}
    both(op, 1, img, boxes, labels, level=7, prob=1.0, **kw)


@pytest.mark.parametrize("seed", range(16))
def test_auto_augment_equals_jax(seed):
    shape = SMALL[seed % len(SMALL)]
    boxes, labels = gts(shape, seed)
    both("auto_augment", seed, frame(shape, seed), boxes, labels)


@pytest.mark.parametrize("policy", range(5))
def test_each_sub_policy_equals_jax(policy):
    """Each of AUTOAUG_POLICIES_V0's sub-policies with every op applied,
    at 765x1360 and an odd width."""
    sub = tuple((name, {**kw, "prob": 1.0})
                for name, kw in taug.AUTOAUG_POLICIES_V0[policy])
    assert taug.AUTOAUG_POLICIES_V0 == jaug.AUTOAUG_POLICIES_V0
    for shape in (SHAPES[-1], SMALL[0]):
        boxes, labels = gts(shape, policy, n=10)
        both("auto_augment", policy, frame(shape, policy), boxes, labels,
             policies=(sub,))


def test_unknown_op_raises_as_jax():
    for mod in (jaug, taug):
        with pytest.raises(ValueError, match="unknown autoaugment op"):
            mod.auto_augment(frame(SMALL[0]), *gts(SMALL[0]),
                             np.random.RandomState(0),
                             policies=((("solarize", {}),),))


@pytest.mark.parametrize("pad_val", [114.6, 127.5, 114.5])
def test_fractional_border_values_equal_jax(pad_val):
    """``cv2.warpAffine`` rounds a fractional ``borderValue`` to the
    image's type; the port used to truncate it."""
    shape = SMALL[2]
    img = frame(shape)
    boxes, labels = gts(shape)
    mat = np.array([[0.9, 0.2, 5.3], [-0.1, 1.1, -4.2]])
    want = cv2.warpAffine(img, mat, (shape[1], shape[0]),
                          borderValue=(pad_val,) * 3)
    np.testing.assert_array_equal(
        warp_affine_u8(torch.from_numpy(img), mat, shape,
                       border_value=pad_val).numpy(), want)
    both("random_affine", 2, img, boxes, labels, out_size=(48, 80),
         pad_val=pad_val)
    assert_same(taug._warp_with_boxes(img, boxes, labels, mat, pad_val),
                jaug._warp_with_boxes(img, boxes, labels, mat, pad_val))


def test_digests_the_smoke_asserts():
    """The card machine has no OpenCV: ``chip_smoke.py``'s ``data_forms``
    phase holds the port's augmentations to this digest, computed here
    from the JAX package, and the port gives it too."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert chip_smoke.augment_digest(jaug) == chip_smoke.AUGMENT_SHA256
    assert chip_smoke.augment_digest(taug) == chip_smoke.AUGMENT_SHA256
