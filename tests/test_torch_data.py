"""The port's data readers against OpenCV and the JAX package.

- ``data/image_io.py``: the PNG reader equals ``cv2.imread`` + BGR->RGB
  value for value on files that ``cv2.imwrite`` wrote (RGB, grey, RGBA,
  odd widths, compression levels that give different filter choices)
  and on files the port's own writer wrote (every filter type); sizes
  from PNG and JPEG headers equal what OpenCV decodes; a progressive
  JPEG raises ``NotImplementedError``; a 16-bit PNG reads as
  ``cv2.imread`` reads it and a PNG header no PNG may have raises.
  (``tests/test_torch_jpeg.py`` and ``test_torch_png_forms.py`` cover the
  JPEG reader and the other PNG forms.)
- ``data/visdrone.py``, ``data/coco.py``, ``data/wrappers.py``: the json,
  records, ignore regions, images and batches equal the JAX package's.
"""

import json
import os
import pickle

import cv2
import numpy as np
import pytest

from glsdet_tpu.data import coco as jcoco
from glsdet_tpu.data import visdrone as jvis
from glsdet_tpu.data import wrappers as jwrap
from glsdet_tpu_torch.data import coco as tcoco
from glsdet_tpu_torch.data import image_io
from glsdet_tpu_torch.data import visdrone as tvis
from glsdet_tpu_torch.data import wrappers as twrap


def cv_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def smooth_frame(rs, h, w, c=3):
    """A smooth field with noise: what real frames look like to the PNG
    filters (Sub/Up/Average/Paeth all win on some rows)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = [(np.sin(yy / (7.0 + k) + xx / (11.0 + 3 * k)) * 90 + 128)
            for k in range(c)]
    img = np.stack(base, -1) + rs.randint(-6, 7, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(17, 33, 3), (5, 1, 3), (40, 31, 1),
                                   (23, 9, 4), (64, 97, 3)])
@pytest.mark.parametrize("level", [0, 3, 9])
def test_png_reader_equals_cv2_imread(tmp_path, shape, level):
    rs = np.random.RandomState(level + shape[1])
    h, w, c = shape
    img = smooth_frame(rs, h, w, c) if level else rs.randint(
        0, 256, shape, np.uint8)
    path = str(tmp_path / "f.png")
    cv2.imwrite(path, img[..., 0] if c == 1 else img,
                [cv2.IMWRITE_PNG_COMPRESSION, level])
    got = image_io.read_image(path)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, cv_rgb(path))
    assert image_io.image_size(path) == (w, h)


def test_png_reader_rejects_what_it_does_not_read(tmp_path):
    """16-bit PNGs (cv2.imwrite of uint16) read as cv2.imread reads them
    (the high byte); a header no PNG may have (RGB at 4 bits) and bytes
    that are not a PNG raise rather than guess."""
    img = np.random.RandomState(0).randint(0, 65536, (11, 13, 3)).astype(
        np.uint16)
    path = str(tmp_path / "b16.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(image_io.read_image(path), cv_rgb(path))
    data = bytearray(open(path, "rb").read())
    ihdr = data.index(b"IHDR") + 4
    data[ihdr + 8] = 4                                 # RGB at bit depth 4
    import struct
    import zlib

    data[ihdr + 13:ihdr + 17] = struct.pack(
        ">I", zlib.crc32(bytes(data[ihdr - 4:ihdr + 13])))
    with pytest.raises(ValueError, match="bit depth 4"):
        image_io.decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.decode_png(b"GIF89a")


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_writer_uses_every_filter_and_reads_back(tmp_path, c):
    rs = np.random.RandomState(c)
    img = smooth_frame(rs, 48, 77, c)
    img[:8] = rs.randint(0, 256, img[:8].shape)       # rows Sub/None win
    if c == 1:
        img = img[..., 0]
    data = image_io.encode_png(img)
    idat = b"".join(body for kind, body in image_io._chunks(data)
                    if kind == b"IDAT")
    import zlib

    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    kinds = set(raw.reshape(48, -1)[:, 0].tolist())
    assert kinds == {0, 1, 2, 3, 4} or len(kinds) >= 4, kinds
    path = str(tmp_path / "own.png")
    image_io.write_png(path, img)
    want = np.repeat(img[..., None], 3, 2) if c == 1 else img[..., :3]
    np.testing.assert_array_equal(image_io.read_image(path), want)
    np.testing.assert_array_equal(image_io.read_image(path), cv_rgb(path))


def test_jpeg_size_from_header_and_decode_raises(tmp_path):
    """The size comes from the header; a progressive JPEG, which this
    test held to the refusal naming item 16 before the decoder took it,
    now reads as ``cv2.imread`` reads it (``tests/test_torch_jpeg.py``);
    an arithmetic-coded one still raises naming item 16."""
    path = str(tmp_path / "f.jpg")
    cv2.imwrite(path, np.random.RandomState(0).randint(0, 256, (37, 53, 3),
                                                       np.uint8),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert image_io.image_size(path) == (53, 37)
    np.testing.assert_array_equal(image_io.read_image(path),
                                  cv2.imread(path)[..., ::-1])
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[data.index(b"\xff\xc2") + 1] = 0xCA       # arithmetic progressive
    with open(path, "wb") as f:
        f.write(bytes(data))
    assert image_io.image_size(path) == (53, 37)
    with pytest.raises(NotImplementedError, match="queue A item 16"):
        image_io.read_image(path)


def test_npy_frames_and_missing_files(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (9, 7, 3), np.uint8)
    np.save(tmp_path / "f.npy", img)
    np.testing.assert_array_equal(
        image_io.read_image(str(tmp_path / "f.npy")), img)
    with pytest.raises(FileNotFoundError):
        image_io.read_image(str(tmp_path / "none.png"))


def write_visdrone(root, rs, n=5):
    """A VisDrone-format split: PNG frames of two sizes and annotation
    txts with ignore (0), "others" (11) and zero-area rows."""
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "annotations"))
    for i in range(n):
        h, w = [(48, 80), (60, 45)][i % 2]
        cv2.imwrite(os.path.join(root, "images", f"{i:04d}.png"),
                    smooth_frame(rs, h, w))
        if i == n - 1:
            continue                       # a frame without a txt
        lines = []
        for _ in range(rs.randint(3, 9)):
            bw, bh = rs.randint(2, 20), rs.randint(2, 20)
            x, y = rs.randint(0, w - bw), rs.randint(0, h - bh)
            cat = int(rs.choice([0, 1, 4, 10, 11, 3]))
            lines.append(f"{x},{y},{bw},{bh},1,{cat},0,0")
        lines.append("5,5,0,7,1,2,0,0")
        with open(os.path.join(root, "annotations", f"{i:04d}.txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def visdrone(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vd"))
    write_visdrone(root, np.random.RandomState(0))
    jvis.visdrone_to_coco(root, os.path.join(root, "jax.json"))
    tvis.visdrone_to_coco(root, os.path.join(root, "port.json"))
    return root


def test_visdrone_to_coco_json_equals_jax(visdrone):
    with open(os.path.join(visdrone, "jax.json")) as f:
        want = f.read()
    with open(os.path.join(visdrone, "port.json")) as f:
        got = f.read()
    assert got == want
    coco = json.loads(got)
    assert coco["ignore_regions"] and coco["annotations"]
    assert {a["category_id"] for a in coco["annotations"]} <= set(range(10))


@pytest.mark.parametrize("filter_empty", [False, True])
def test_coco_dataset_equals_jax(visdrone, filter_empty):
    ann = os.path.join(visdrone, "port.json")
    img_root = os.path.join(visdrone, "images")
    jd = jcoco.CocoDataset(ann, img_root, filter_empty=filter_empty)
    td = tcoco.CocoDataset(ann, img_root, filter_empty=filter_empty)
    assert len(td) == len(jd) and td.class_names == jd.class_names
    for jr, tr in zip(jd.records, td.records):
        assert (tr.img_id, tr.file_name, tr.width, tr.height) == (
            jr.img_id, jr.file_name, jr.width, jr.height)
        np.testing.assert_array_equal(tr.boxes, jr.boxes)
        np.testing.assert_array_equal(tr.labels, jr.labels)
        assert tr.labels.dtype == jr.labels.dtype == np.int32
        np.testing.assert_array_equal(td.load_image(tr), jd.load_image(jr))
    assert td.ignore_regions.keys() == jd.ignore_regions.keys()
    for k in jd.ignore_regions:
        np.testing.assert_array_equal(td.ignore_regions[k],
                                      jd.ignore_regions[k])


def test_decode_cache_budget_and_pickling(visdrone):
    ann = os.path.join(visdrone, "port.json")
    img_root = os.path.join(visdrone, "images")
    first = tcoco.CocoDataset(ann, img_root).load_image(
        tcoco.CocoDataset(ann, img_root).records[0])
    ds = tcoco.CocoDataset(ann, img_root, cache_images=True,
                           cache_bytes=first.nbytes)
    a = ds.load_image(ds.records[0])
    assert ds.load_image(ds.records[0]) is a and not a.flags.writeable
    ds.load_image(ds.records[1])           # over the budget: not kept
    assert len(ds._cache) == 1 and ds._cache_used == first.nbytes
    clone = pickle.loads(pickle.dumps(ds))     # what a worker receives
    assert clone._cache == {} and clone._cache_used == 0
    np.testing.assert_array_equal(clone.load_image(clone.records[0]), a)
    assert len(clone._cache) == 1


def test_images_to_coco_equals_jax(visdrone, tmp_path):
    img_dir = os.path.join(visdrone, "images")
    want = jcoco.images_to_coco(img_dir, class_names=("a", "b"))
    got = tcoco.images_to_coco(img_dir, str(tmp_path / "x.json"),
                               class_names=("a", "b"))
    assert got == want
    with open(tmp_path / "x.json") as f:
        assert json.load(f) == want


def test_pad_gts_and_make_batch_equal_jax():
    rs = np.random.RandomState(0)
    boxes = rs.rand(7, 4).astype(np.float32)
    labels = rs.randint(0, 10, 7).astype(np.int32)
    for max_gt in (5, 9):
        for a, b in zip(tcoco.pad_gts(boxes, labels, max_gt),
                        jcoco.pad_gts(boxes, labels, max_gt)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    samples = [{"x": rs.rand(3, 2), "y": np.int32(i)} for i in range(4)]
    got, want = tcoco.make_batch(samples), jcoco.make_batch(samples)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_dataset_wrappers_equal_jax(visdrone):
    ann = os.path.join(visdrone, "port.json")
    img_root = os.path.join(visdrone, "images")
    jd = jcoco.CocoDataset(ann, img_root)
    td = tcoco.CocoDataset(ann, img_root)
    pairs = [
        (jwrap.RepeatDataset(jd, 3), twrap.RepeatDataset(td, 3)),
        (jwrap.ClassBalancedDataset(jd, 0.3),
         twrap.ClassBalancedDataset(td, 0.3)),
        (jwrap.ConcatDataset([jd, jd]), twrap.ConcatDataset([td, td])),
    ]
    for jw, tw in pairs:
        assert len(tw) == len(jw)
        assert [r.img_id for r in tw.records] == [r.img_id
                                                  for r in jw.records]
        np.testing.assert_array_equal(tw.load_image(tw.records[-1]),
                                      jw.load_image(jw.records[-1]))
