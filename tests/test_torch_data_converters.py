"""The port's UAVDT and VOC converters (``data/uavdt.py``,
``data/voc.py``) write what the JAX package's write on synthetic trees:
the same COCO json, VOC xml, image-set lists and txt lines; image sizes
come from the frames' JPEG headers."""

import json
import os

import numpy as np
import pytest

from glsdet_tpu.data import uavdt as juavdt
from glsdet_tpu.data import voc as jvoc
from glsdet_tpu_torch.data import uavdt as tuavdt
from glsdet_tpu_torch.data import voc as tvoc
from glsdet_tpu_torch.data.image_io import write_jpeg


def write_uavdt(root, rs, frames_hw=None):
    """Two train sequences and one test sequence (M0203): gt lines with
    bad rows (short, zero size, category 0 or 4), frames optionally
    written as JPEGs of ``frames_hw``."""
    os.makedirs(os.path.join(root, "GT"))
    for seq in ("M0101", "M0203", "M0305"):
        lines = []
        for frame in range(1, 6):
            for obj in range(rs.randint(0, 5)):
                x, y = rs.uniform(0, 900), rs.uniform(0, 480)
                w, h = rs.uniform(-2, 60), rs.uniform(1, 40)
                cat = int(rs.choice([0, 1, 2, 3, 4]))
                lines.append(f"{frame},{obj},{x:.2f},{y:.2f},{w:.2f},"
                             f"{h:.2f},1,1,{cat}")
        lines.append("3,1,2,3")
        with open(os.path.join(root, "GT", f"{seq}_gt_whole.txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
        if frames_hw:
            d = os.path.join(root, "UAV-benchmark-M", seq)
            os.makedirs(d)
            for frame in range(1, 6):
                write_jpeg(os.path.join(d, f"img{frame:06d}.jpg"),
                           rs.randint(0, 256, (*frames_hw, 3), np.uint8))


@pytest.mark.parametrize("split", ["train", "test"])
def test_uavdt_to_coco_equals_jax(tmp_path, split):
    root = str(tmp_path)
    write_uavdt(root, np.random.RandomState(0))
    want = juavdt.uavdt_to_coco(root, str(tmp_path / "j.json"), split)
    got = tuavdt.uavdt_to_coco(root, str(tmp_path / "t.json"), split)
    assert got == want and want["images"]
    assert open(tmp_path / "t.json").read() == open(tmp_path / "j.json").read()
    assert tuavdt.UAVDT_CLASSES == juavdt.UAVDT_CLASSES
    assert tuavdt.UAVDT_TEST_SEQS == juavdt.UAVDT_TEST_SEQS


def test_uavdt_sizes_from_jpeg_headers(tmp_path):
    root = str(tmp_path)
    write_uavdt(root, np.random.RandomState(1), frames_hw=(54, 102))
    got = tuavdt.uavdt_to_coco(root, str(tmp_path / "t.json"))
    assert {(im["width"], im["height"]) for im in got["images"]} == {
        (102, 54)}
    # explicit sizes win, as the JAX package's arguments
    want = juavdt.uavdt_to_coco(root, str(tmp_path / "j.json"), img_w=640,
                                img_h=360)
    assert tuavdt.uavdt_to_coco(root, str(tmp_path / "t2.json"), img_w=640,
                                img_h=360) == want


CLASSES = ("pedestrian", "car", "bus")


def write_voc(root, rs, n=6):
    """A VOC-layout tree: xmls with unknown classes, difficult and
    degenerate boxes, one xml without <size>; JPEG frames."""
    import xml.etree.ElementTree as ET

    for d in ("Annotations", "ImageSets/Main", "JPEGImages"):
        os.makedirs(os.path.join(root, d))
    ids = [f"{i:06d}" for i in range(n)]
    for k, image_id in enumerate(ids):
        h, w = (40, 64) if k % 2 else (48, 50)
        write_jpeg(os.path.join(root, "JPEGImages", f"{image_id}.jpg"),
                   rs.randint(0, 256, (h, w, 3), np.uint8))
        ann = ET.Element("annotation")
        if k != 3:
            size = ET.SubElement(ann, "size")
            ET.SubElement(size, "width").text = str(w)
            ET.SubElement(size, "height").text = str(h)
        for _ in range(rs.randint(1, 6)):
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = str(rs.choice(
                CLASSES + ("dog",)))
            ET.SubElement(obj, "difficult").text = str(int(rs.rand() < 0.2))
            bb = ET.SubElement(obj, "bndbox")
            x1, y1 = rs.randint(0, w - 5), rs.randint(0, h - 5)
            x2 = x1 + rs.randint(0, 20) if rs.rand() > 0.1 else x1
            for key, v in zip(("xmin", "ymin", "xmax", "ymax"),
                              (x1, y1, x2, y1 + rs.randint(1, 20))):
                ET.SubElement(bb, key).text = str(v)
        ET.ElementTree(ann).write(os.path.join(root, "Annotations",
                                               f"{image_id}.xml"))
    with open(os.path.join(root, "ImageSets/Main/train.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return ids


def test_voc_functions_equal_jax(tmp_path):
    root = str(tmp_path / "voc")
    ids = write_voc(root, np.random.RandomState(0))
    c2i = {n: i for i, n in enumerate(CLASSES)}
    for image_id in ids:
        xml = os.path.join(root, "Annotations", f"{image_id}.xml")
        assert tvoc.parse_voc_xml(xml, c2i) == jvoc.parse_voc_xml(xml, c2i)
    with_size = [i for k, i in enumerate(ids) if k != 3]
    want = jvoc.voc_to_coco(root, str(tmp_path / "j.json"), CLASSES,
                            ids=with_size)
    got = tvoc.voc_to_coco(root, str(tmp_path / "t.json"), CLASSES,
                           ids=with_size)
    assert got == want
    assert tvoc.voc_to_txt_lines(root, CLASSES) != []
    # the xml without <size>: the JAX package writes 0 x 0, the port reads
    # the frame's header
    full = tvoc.voc_to_coco(root, "", CLASSES)
    jfull = jvoc.voc_to_coco(root, "", CLASSES)
    assert (jfull["images"][3]["width"], jfull["images"][3]["height"]) == (
        0, 0)
    assert (full["images"][3]["width"], full["images"][3]["height"]) == (
        64, 40)
    assert full["annotations"] == jfull["annotations"]
    with_size_lines = [line for line in jvoc.voc_to_txt_lines(root, CLASSES)]
    assert tvoc.voc_to_txt_lines(root, CLASSES) == with_size_lines


def test_coco_to_voc_equals_jax(tmp_path):
    root = str(tmp_path / "voc")
    write_voc(root, np.random.RandomState(1))
    coco = jvoc.voc_to_coco(root, "", CLASSES)
    n_j = jvoc.coco_to_voc(coco, str(tmp_path / "j"))
    n_t = tvoc.coco_to_voc(coco, str(tmp_path / "t"))
    assert n_j == n_t == len(coco["images"])
    for dirpath, _, files in os.walk(str(tmp_path / "j")):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name),
                                  str(tmp_path / "j"))
            with open(os.path.join(str(tmp_path / "t"), rel), "rb") as f:
                mine = f.read()
            with open(os.path.join(dirpath, name), "rb") as f:
                assert mine == f.read(), rel
    assert json.dumps(coco)
