"""Writes the JPEG fixtures of ``tests/torch_fixtures/jpeg_forms``, which
``chip_smoke.py``'s ``data_forms`` phase decodes on the GPU machine,
where there is no OpenCV and no PIL, and ``tests/test_torch_jpeg.py``
holds to ``cv2.imdecode`` / ``cv2.imread`` here:

- ``progressive_765x1360.jpg``: a VisDrone-sized frame (the smoke's
  synthetic scene) through ``cv2.imencode`` with
  ``IMWRITE_JPEG_PROGRESSIVE`` (4:2:0, quality 80), which the smoke also
  serves over HTTP;
- ``cmyk_765x1360.jpg``: a four-component frame of the same size through
  PIL (Adobe CMYK, inverted, 4:4:4, quality 75), served as well;
- small files of the other forms: ``cv2`` progressive 4:4:4 with a
  restart interval, ``cv2`` progressive grey, PIL progressive with
  optimized tables, PIL baseline with optimized tables, PIL progressive
  CMYK, and ``cut_progressive.jpg``, a progressive file cut inside its
  third scan, which ``cv2.imread`` reads with libjpeg's block smoothing.

    python tests/torch_fixtures/make_jpeg_forms.py

Prints ``JPEG_FORMS``, the digests ``chip_smoke.py`` holds the files to:
for each file the sha256 of its bytes and of the RGB pixels OpenCV reads
from it (``cv2.imread`` for the cut file, ``cv2.imdecode`` for the
others).  Not run by the tests: it rewrites the committed files.
"""

import hashlib
import io
import os
import sys

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "jpeg_forms")
ROOT = os.path.dirname(os.path.dirname(HERE))
FULL_HW = (765, 1360)


def scene(seed, hw):
    """The smoke's synthetic VisDrone scene, drawn at 128 px or more a
    side (its boxes are up to 64 px) and cropped to ``hw``."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    h, w = hw
    img = chip_smoke.synth_visdrone_pixels(seed, (max(h, 128), max(w, 128)))
    return np.ascontiguousarray(img[0][:h, :w])


def cv_jpeg(img, *params):
    src = img if img.ndim == 2 else img[..., ::-1]
    ok, buf = cv2.imencode(".jpg", src, list(params))
    assert ok
    return buf.tobytes()


def pil_jpeg(img, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def cmyk(seed, hw):
    """C, M, Y from a scene, K a smooth ramp: every ink varies."""
    rgb = scene(seed, hw).astype(np.int32)
    h, w = hw
    k = (np.add.outer(np.arange(h) * 120 // h, np.arange(w) * 80 // w)
         ).astype(np.int32)
    return np.clip(np.concatenate([255 - rgb, k[..., None]], -1), 0,
                   255).astype(np.uint8)


def cut_in_scan(data, scan, share=0.5):
    """``data`` cut ``share`` of the way into scan ``scan``'s entropy
    data (no EOI)."""
    pos = -1
    for _ in range(scan + 1):
        pos = data.index(b"\xff\xda", pos + 1)
    start = pos + 2 + (data[pos + 2] << 8 | data[pos + 3])
    end = data.index(b"\xff\xda", start) if b"\xff\xda" in data[start:] \
        else len(data) - 2
    return data[:start + int((end - start) * share)]


def fixtures() -> dict:
    small = scene(7, (77, 131))
    return {
        "progressive_765x1360.jpg": cv_jpeg(
            scene(3, FULL_HW), cv2.IMWRITE_JPEG_QUALITY, 80,
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "cmyk_765x1360.jpg": pil_jpeg(cmyk(4, FULL_HW), "CMYK", quality=75),
        "progressive_444_rst.jpg": cv_jpeg(
            small, cv2.IMWRITE_JPEG_QUALITY, 90,
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
        "progressive_grey.jpg": cv_jpeg(
            scene(8, (61, 45))[..., 1], cv2.IMWRITE_JPEG_QUALITY, 85,
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "pil_progressive.jpg": pil_jpeg(scene(9, (96, 160)), "RGB",
                                        quality=70, progressive=True,
                                        optimize=True),
        "pil_optimized.jpg": pil_jpeg(scene(10, (50, 83)), "RGB",
                                      quality=90, optimize=True),
        "pil_cmyk_progressive.jpg": pil_jpeg(cmyk(11, (40, 57)), "CMYK",
                                             quality=85, progressive=True),
        "cut_progressive.jpg": cut_in_scan(cv_jpeg(
            scene(12, (64, 96)), cv2.IMWRITE_JPEG_QUALITY, 85,
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1), 2),
    }


def opencv_pixels(name: str, path: str) -> np.ndarray:
    """RGB pixels as OpenCV reads the file: ``cv2.imread`` for the file
    cut short (``cv2.imdecode`` refuses it), ``cv2.imdecode`` else."""
    if name.startswith("cut_"):
        bgr = cv2.imread(path)
    else:
        with open(path, "rb") as f:
            bgr = cv2.imdecode(np.frombuffer(f.read(), np.uint8),
                               cv2.IMREAD_COLOR)
    return np.ascontiguousarray(bgr[..., ::-1])


def digests() -> dict:
    out = {}
    for name in sorted(os.listdir(OUT)):
        path = os.path.join(OUT, name)
        with open(path, "rb") as f:
            data = f.read()
        out[name] = (hashlib.sha256(data).hexdigest(), hashlib.sha256(
            opencv_pixels(name, path).tobytes()).hexdigest())
    return out


def main():
    os.makedirs(OUT, exist_ok=True)
    total = 0
    for name, data in fixtures().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        total += len(data)
        print(f"{name}: {len(data)} bytes", file=sys.stderr)
    print(f"total {total} bytes", file=sys.stderr)
    print("JPEG_FORMS = {")
    for name, (b, p) in digests().items():
        print(f'    "{name}": (\n        "{b}",\n        "{p}"),')
    print("}")


if __name__ == "__main__":
    main()
