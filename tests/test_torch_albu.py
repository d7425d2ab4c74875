"""The port's ``Albu`` bridge against the JAX package's.

Neither machine has albumentations: the gate is tested directly (both
bridges raise ``ImportError`` naming the package), and the bridge runs
through the albumentations protocol shim of ``tests/test_albu.py`` on
its cases.  Images, boxes and labels must equal the JAX bridge's
(tolerance 0).
"""

import sys

import numpy as np
import pytest

from glsdet_tpu.data.augment import Albu as JaxAlbu
from glsdet_tpu_torch.data.augment import Albu
from test_albu import _make_shim


@pytest.fixture()
def shim(monkeypatch):
    monkeypatch.setitem(sys.modules, "albumentations", _make_shim())


def _data():
    img = (np.arange(100 * 80 * 3) % 251).astype(np.uint8).reshape(100, 80, 3)
    boxes = np.array([[10, 10, 30, 40], [50, 20, 54, 24]], np.float32)
    labels = np.array([2, 5], np.int64)
    return img, boxes, labels


def test_missing_package_raises_as_jax():
    assert "albumentations" not in sys.modules
    for cls in (JaxAlbu, Albu):
        with pytest.raises(ImportError, match="albumentations"):
            cls([{"type": "HorizontalFlip", "p": 1.0}])


CASES = {
    "flip": ([{"type": "HorizontalFlip", "p": 1.0}], None),
    "filtration": ([{"type": "DropTinyBoxes", "min_side": 10}], None),
    "nested": ([{"type": "OneOf", "p": 0.5, "transforms": [
        {"type": "HorizontalFlip", "p": 1.0}]}], None),
    "flip_then_drop": ([{"type": "HorizontalFlip", "p": 1.0},
                        {"type": "DropTinyBoxes", "min_side": 10}],
                       {"min_visibility": 0.0,
                        "filter_lost_elements": True}),
}


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bridge_equals_jax(shim, case, empty):
    transforms, bbox_params = CASES[case]
    img, boxes, labels = _data()
    if empty:
        boxes, labels = boxes[:0], labels[:0]
    want = JaxAlbu(transforms, bbox_params)(img, boxes, labels)
    got = Albu(transforms, bbox_params)(img, boxes, labels)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_filtration_keeps_labels_aligned(shim):
    img, boxes, labels = _data()
    _, out_boxes, out_labels = Albu(
        [{"type": "DropTinyBoxes", "min_side": 10}])(img, boxes, labels)
    np.testing.assert_array_equal(out_boxes, [[10, 10, 30, 40]])
    np.testing.assert_array_equal(out_labels, [2])


def test_transform_classes_build_from_the_spec(shim):
    """A ``type`` may be the class itself, as in the JAX bridge."""
    mod = sys.modules["albumentations"]
    img, boxes, labels = _data()
    out_img, out_boxes, _ = Albu([{"type": mod.HorizontalFlip, "p": 1.0}])(
        img, boxes, labels)
    np.testing.assert_array_equal(out_img, img[:, ::-1])
    np.testing.assert_array_equal(out_boxes, [[50, 10, 70, 40],
                                              [26, 20, 30, 24]])
