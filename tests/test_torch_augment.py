"""The port's augmentations against OpenCV and the JAX package.

Every comparison here is bit for bit but one, the JAX package's own
envelope of its device colour stage against OpenCV (stated in its
test):

- ``ops/image.py: warp_affine_u8`` equals ``cv2.warpAffine`` (INTER_LINEAR,
  border 114) over ``random_affine_params`` matrices, the identity, a
  pure scale and a flip, at output widths with and without a scalar
  tail past OpenCV's 16-column blocks;
- ``data/augment.py: rgb_to_hsv_cv`` / ``hsv_to_rgb_cv`` equal
  ``cv2.cvtColor`` (exhaustively over the RGB cube, and over every HSV
  code) at widths with and without a tail;
- each YOLOX-recipe augmentation equals the JAX package's on the same
  ``RandomState`` draws (boxes, labels and pixels), and consumes the same
  number of draws;
- the device colour stage and ``geom_warp`` equal the JAX package's
  functions run eagerly.
"""

import jax
import jax.numpy as jnp
import cv2
import numpy as np
import pytest
import torch

from glsdet_tpu.data import augment as jaug
from glsdet_tpu.data import device_color as jdc
from glsdet_tpu.data import device_geom as jdg
from glsdet_tpu_torch.data import augment as taug
from glsdet_tpu_torch.data import device_color as tdc
from glsdet_tpu_torch.data import device_geom as tdg
from glsdet_tpu_torch.ops.image import warp_affine_u8


def frames(seed, shapes):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (*s, 3), np.uint8) for s in shapes]


def gts(seed, shape, n=6):
    rs = np.random.RandomState(seed)
    h, w = shape
    x1, y1 = rs.uniform(0, w - 8, n), rs.uniform(0, h - 8, n)
    boxes = np.stack([x1, y1, x1 + rs.uniform(2, w / 3, n),
                      y1 + rs.uniform(2, h / 3, n)], 1).astype(np.float32)
    return boxes, rs.randint(0, 10, n).astype(np.int32)


WARP_CASES = [((160, 200), (80, 100)), ((150, 190), (75, 90)),
              ((97, 61), (50, 37)), ((128, 128), (64, 64))]


@pytest.mark.parametrize("src,out", WARP_CASES)
def test_warp_affine_u8_equals_cv2(src, out):
    rs = np.random.RandomState(src[1])
    img = rs.randint(0, 256, (*src, 3), np.uint8)
    h, w = src
    mats = [np.eye(3)[:2], np.array([[0.5, 0.0, 3.2], [0.0, 0.75, -1.5]]),
            np.array([[-1.0, 0.0, w - 1.0], [0.0, 1.0, 0.0]])]
    mats += [jaug.random_affine_params(rs, src, out)[:2] for _ in range(12)]
    for mat in mats:
        want = cv2.warpAffine(img, mat, (out[1], out[0]),
                              borderValue=(114,) * 3)
        got = warp_affine_u8(torch.from_numpy(img), mat, out).numpy()
        np.testing.assert_array_equal(got, want)


def test_rgb_to_hsv_equals_cv2_over_the_cube():
    cube = np.stack(np.meshgrid(np.arange(256), np.arange(256),
                                np.arange(256), indexing="ij"), -1)
    cube = cube.reshape(2048, 8192, 3).astype(np.uint8)
    np.testing.assert_array_equal(taug.rgb_to_hsv_cv(cube),
                                  cv2.cvtColor(cube, cv2.COLOR_RGB2HSV))


def test_hsv_to_rgb_equals_cv2_over_every_code():
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256),
                               np.arange(256), indexing="ij"), -1)
    hsv = hsv.reshape(180 * 256, 256, 3).astype(np.uint8)
    np.testing.assert_array_equal(taug.hsv_to_rgb_cv(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("hw", [(48, 48), (7, 33), (5, 1), (13, 100)])
def test_hsv_pair_equals_cv2_with_row_tails(hw):
    rs = np.random.RandomState(hw[1])
    img = rs.randint(0, 256, (*hw, 3), np.uint8)
    hsv = np.stack([rs.randint(0, 180, hw), rs.randint(0, 256, hw),
                    rs.randint(0, 256, hw)], -1).astype(np.uint8)
    np.testing.assert_array_equal(taug.rgb_to_hsv_cv(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    np.testing.assert_array_equal(taug.hsv_to_rgb_cv(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def same_draws(fn_jax, fn_port, seed):
    """Run both with RandomState(seed); both must leave the stream at the
    same place."""
    rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
    out = fn_jax(rj), fn_port(rt)
    assert rj.randint(2 ** 31) == rt.randint(2 ** 31)
    return out


def assert_tree_equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("seed", range(3))
def test_box_and_parameter_draws_equal_jax(seed):
    shapes = [(60, 100), (80, 64), (50, 90), (70, 70)]
    assert_tree_equal(*same_draws(
        lambda r: jaug.mosaic4_params(shapes, (48, 64), r),
        lambda r: taug.mosaic4_params(shapes, (48, 64), r), seed))
    assert_tree_equal(*same_draws(
        lambda r: jaug.random_affine_params(r, (96, 128), (48, 64)),
        lambda r: taug.random_affine_params(r, (96, 128), (48, 64)), seed))
    assert_tree_equal(*same_draws(jaug.sample_hsv_deltas,
                                  taug.sample_hsv_deltas, seed))
    _, _, quads = jaug.mosaic4_params(shapes, (48, 64),
                                      np.random.RandomState(seed))
    bl = [gts(seed + i, s) for i, s in enumerate(shapes)]
    bl[2] = (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32))
    args = (quads, [b for b, _ in bl], [lab for _, lab in bl], (48, 64))
    assert_tree_equal(jaug.mosaic4_boxes(*args), taug.mosaic4_boxes(*args))
    mat = jaug.random_affine_params(np.random.RandomState(seed), (96, 128),
                                    (48, 64))
    boxes, labels = gts(seed, (96, 128), 12)
    assert_tree_equal(jaug.affine_boxes(mat, boxes, labels, (48, 64)),
                      taug.affine_boxes(mat, boxes, labels, (48, 64)))


@pytest.mark.parametrize("seed", range(3))
def test_pixel_augmentations_equal_jax(seed):
    imgs = frames(seed, [(60, 100), (80, 64), (50, 90), (70, 70)])
    bl = [gts(seed + i, im.shape[:2]) for i, im in enumerate(imgs)]
    boxes, labels = bl[0]
    assert_tree_equal(jaug.letterbox(imgs[1], boxes, (48, 64)),
                      taug.letterbox(imgs[1], boxes, (48, 64)))
    assert_tree_equal(*same_draws(lambda r: jaug.hsv_aug(imgs[3], r),
                                  lambda r: taug.hsv_aug(imgs[3], r), seed))
    assert_tree_equal(*same_draws(
        lambda r: jaug.random_flip(imgs[0], boxes, r, 0.5),
        lambda r: taug.random_flip(imgs[0], boxes, r, 0.5), seed))
    mos_args = (imgs, [b for b, _ in bl], [lab for _, lab in bl], (48, 64))
    (jimg, jb, jl), (timg, tb, tl) = same_draws(
        lambda r: jaug.mosaic4(*mos_args, r),
        lambda r: taug.mosaic4(*mos_args, r), seed)
    assert_tree_equal((jimg, jb, jl), (timg, tb, tl))
    assert_tree_equal(*same_draws(
        lambda r: jaug.random_affine(jimg, jb, jl, r, (48, 64)),
        lambda r: taug.random_affine(jimg, jb, jl, r, (48, 64)), seed))
    lb, _, _, _ = jaug.letterbox(imgs[2], bl[2][0], (96, 128))
    assert_tree_equal(*same_draws(
        lambda r: jaug.mixup(jimg, jb, jl, lb, bl[2][0], bl[2][1], r),
        lambda r: taug.mixup(jimg, jb, jl, lb, bl[2][0], bl[2][1], r),
        seed))


def t(x):
    return torch.from_numpy(np.array(x))


def test_device_color_equals_jax_eager():
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (3, 20, 36, 3)).astype(np.uint8)
    mix = rs.randint(0, 256, (3, 20, 36, 3)).astype(np.uint8)
    weight = np.array([1.0, 0.5, 0.5], np.float32)
    deltas = np.array([[3, -20, 11], [-5, 30, -30], [0, 0, 0]], np.float32)
    codes = rs.randint(0, 256, (50000, 3)).astype(np.float32)
    hsv = np.stack([rs.randint(0, 180, 50000), rs.randint(0, 256, 50000),
                    rs.randint(0, 256, 50000)], -1).astype(np.float32)
    with jax.disable_jit():
        pairs = [
            (jdc.rgb_to_hsv_u8(jnp.asarray(codes)),
             tdc.rgb_to_hsv_u8(t(codes))),
            (jdc.hsv_to_rgb_u8(jnp.asarray(hsv)), tdc.hsv_to_rgb_u8(t(hsv))),
            (jdc.hsv_jitter(jnp.asarray(img, jnp.float32),
                            jnp.asarray(deltas)[:, None, None]),
             tdc.hsv_jitter(t(img).float(), t(deltas)[:, None, None])),
            (jdc.apply_color(jnp.asarray(img), jnp.asarray(mix),
                             jnp.asarray(weight), jnp.asarray(deltas)),
             tdc.apply_color(t(img), t(mix), t(weight), t(deltas))),
            (jdc.prep_batch_images({"images": jnp.asarray(img),
                                    "hsv_deltas": jnp.asarray(deltas)},
                                   True),
             tdc.prep_batch_images({"images": t(img),
                                    "hsv_deltas": t(deltas)}, True)),
        ]
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a plain batch is passed through untouched
    assert tdc.apply_batch_color({"images": t(img)}).dtype == torch.uint8


def test_device_color_within_the_jax_envelope_of_opencv():
    """The JAX package's envelope of the device colour stage against
    OpenCV (tests/test_device_color.py): RGB -> HSV and HSV -> RGB codes
    within +-1; a jitter within 16 codes, mean below 1 and at most 2% of
    values off by more than 2, against OpenCV's own uint8 round trip
    (which the host path, ``taug.hsv_aug``, equals)."""
    img = np.random.RandomState(0).randint(0, 256, (48, 64, 3), np.uint8)
    hsv_cv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.int64)
    hsv = tdc.rgb_to_hsv_u8(t(img).float()).numpy().astype(np.int64)
    dh = np.abs(hsv[..., 0] - hsv_cv[..., 0])
    assert np.minimum(dh, 180 - dh).max() <= 1
    assert np.abs(hsv[..., 1:] - hsv_cv[..., 1:]).max() <= 1
    back = tdc.hsv_to_rgb_u8(t(hsv_cv).float()).numpy()
    assert np.abs(back - cv2.cvtColor(hsv_cv.astype(np.uint8),
                                      cv2.COLOR_HSV2RGB)).max() <= 1
    rs = np.random.RandomState(1)
    deltas = [np.zeros(3)] + [np.array([rs.randint(-5, 6),
                                        rs.randint(-30, 31),
                                        rs.randint(-30, 31)])
                              for _ in range(3)]
    for d in deltas:
        j = hsv_cv.copy()
        j[..., 0] = (j[..., 0] + d[0]) % 180
        j[..., 1:] = np.clip(j[..., 1:] + d[1:], 0, 255)
        ref = cv2.cvtColor(j.astype(np.uint8), cv2.COLOR_HSV2RGB)
        np.testing.assert_array_equal(taug.hsv_to_rgb_cv(j.astype(np.uint8)),
                                      ref)
        got = tdc.hsv_jitter(t(img).float(), t(d).float()).numpy()
        diff = np.abs(got - ref)
        assert diff.max() <= 16
        assert diff.mean() < 1.0
        assert (diff > 2).mean() < 0.02


def geom_inputs(seed, b=2):
    rs = np.random.RandomState(seed)
    shapes = [(30, 50), (40, 36), (28, 28), (50, 60)]
    srcs = np.zeros((b, 4, 50, 60, 3), np.uint8)
    quads, mats = [], []
    for k in range(b):
        for i, (h, w) in enumerate(shapes):
            srcs[k, i, :h, :w] = rs.randint(0, 256, (h, w, 3))
        _, _, q = jaug.mosaic4_params(shapes, (32, 48), rs)
        mat = jaug.random_affine_params(rs, (64, 96), (32, 48))
        if k:
            mat = jdg.flip_affine(mat, 48)
            assert np.array_equal(tdg.flip_affine(
                jaug.random_affine_params(np.random.RandomState(k),
                                          (64, 96), (32, 48)), 48),
                jdg.flip_affine(jaug.random_affine_params(
                    np.random.RandomState(k), (64, 96), (32, 48)), 48))
        quads.append(jdg.quads_to_array(q, shapes))
        np.testing.assert_array_equal(tdg.quads_to_array(q, shapes),
                                      quads[-1])
        mats.append(jdg.inverse_affine_2x3(mat))
        np.testing.assert_array_equal(tdg.inverse_affine_2x3(mat), mats[-1])
    return srcs, np.stack(quads), np.stack(mats)


@pytest.mark.parametrize("seed", range(2))
def test_geom_warp_equals_jax_eager(seed):
    srcs, quads, mats = geom_inputs(seed)
    with jax.disable_jit():
        want = jdg.geom_warp(jnp.asarray(srcs), jnp.asarray(quads),
                             jnp.asarray(mats), (32, 48))
        jbatch = jdc.apply_batch_color(
            {"geom_sources": jnp.asarray(srcs),
             "geom_quads": jnp.asarray(quads),
             "geom_mat": jnp.asarray(mats),
             "hsv_deltas": jnp.asarray([[2.0, 5.0, -7.0]] * 2)}, (32, 48))
    got = tdg.geom_warp(t(srcs), t(quads), t(mats), (32, 48))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    batch = {"geom_sources": t(srcs), "geom_quads": t(quads),
             "geom_mat": t(mats),
             "hsv_deltas": t([[2.0, 5.0, -7.0]] * 2)}
    np.testing.assert_array_equal(
        tdc.apply_batch_color(batch, (32, 48)).numpy(), np.asarray(jbatch))
    with pytest.raises(ValueError, match="out_hw"):
        tdc.apply_batch_color(batch)
