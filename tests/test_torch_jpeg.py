"""The port's JPEG decoder and encoder (``data/image_io.py`` over
``native/jpeg.cpp``) against OpenCV, and the HTTP body decoder against
the JAX package's.

- ``decode_jpeg`` / ``read_image`` equal ``cv2.imdecode`` / ``cv2.imread``
  (IMREAD_COLOR) after BGR -> RGB, bit for bit, over sizes 1x1 to
  765x1360, sampling 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1, grey,
  qualities 50-100, restart intervals and all eight EXIF orientations;
- files cut short read as each OpenCV reader reads them (``imdecode``
  refuses bytes without EOI, ``imread`` reads the end of a file as EOI);
  progressive, arithmetic-coded, 12-bit and CMYK files raise naming
  ROADMAP item 16;
- ``cv2.imdecode`` of ``encode_jpeg``'s bytes equals ``cv2.imdecode`` of
  ``cv2.imencode``'s at the same quality (the same coefficients);
- the digests ``chip_smoke.py`` asserts on the card machine;
- ``serve._decode_image`` of the port, with ``cv2`` blocked, equals the
  JAX package's on raw JPEG, raw PNG and base64 JSON bodies.
"""

import base64
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest

from glsdet_tpu_torch.data import image_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = [(1, 1), (7, 9), (33, 47), (765, 1360)]


def frame(h, w, seed=0):
    """A smooth field with noise and saturated rectangles (edges ring and
    clip in the IDCT, colours change fast for the chroma upsamplers)."""
    rs = np.random.RandomState(seed + h * 7 + w)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(yy / (5.0 + 3 * k) + xx / (9.0 + 2 * k)) * 100
                    + 128 for k in range(3)], -1)
    img += rs.normal(0, 12, (h, w, 3))
    for _ in range(max(1, h * w // 4000)):
        y0, x0 = rs.randint(0, h), rs.randint(0, w)
        img[y0:y0 + rs.randint(1, 40), x0:x0 + rs.randint(1, 40)] = \
            rs.choice([0, 255], 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def cv_encode(img_rgb, *params):
    src = img_rgb if img_rgb.ndim == 2 else img_rgb[..., ::-1]
    ok, buf = cv2.imencode(".jpg", src, list(params))
    assert ok
    return buf.tobytes()


def cv_decode(data):
    arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if arr is None else arr[..., ::-1]


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("hw", SIZES)
def test_decoder_equals_cv2(tmp_path, hw, sampling, quality):
    data = cv_encode(frame(*hw), cv2.IMWRITE_JPEG_QUALITY, quality,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling])
    got = image_io.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == (*hw, 3)
    np.testing.assert_array_equal(got, cv_decode(data))
    path = str(tmp_path / "f.jpg")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(image_io.read_image(path),
                                  cv2.imread(path)[..., ::-1])
    assert image_io.image_size(path) == (hw[1], hw[0])


@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("hw", SIZES)
def test_grey_decodes_to_three_equal_channels(hw, quality):
    data = cv_encode(frame(*hw)[..., 1], cv2.IMWRITE_JPEG_QUALITY, quality)
    got = image_io.decode_jpeg(data)
    np.testing.assert_array_equal(got, cv_decode(data))
    assert (got == got[..., :1]).all()


@pytest.mark.parametrize("hw,sampling,interval", [
    ((33, 47), "420", 1), ((33, 47), "444", 2), ((33, 47), "411", 3),
    ((33, 47), "422", 5), ((7, 9), "440", 1), ((765, 1360), "420", 4)])
def test_restart_intervals(hw, sampling, interval):
    data = cv_encode(frame(*hw), cv2.IMWRITE_JPEG_QUALITY, 90,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                     cv2.IMWRITE_JPEG_RST_INTERVAL, interval)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    np.testing.assert_array_equal(image_io.decode_jpeg(data),
                                  cv_decode(data))


CUTS = ["half", "tenth_off", "no_eoi", "header", "half_eoi"]


@pytest.mark.parametrize("interval", [0, 3])
@pytest.mark.parametrize("cut", CUTS)
def test_files_cut_short_read_as_cv2_reads_them(tmp_path, cut, interval):
    """cv2.imdecode refuses bytes that end before EOI (its memory source
    suspends); cv2.imread's file source reads a fake EOI there, so a file
    cut inside its scan decodes, mid grey from the block where the data
    ran out; a cut in the headers is refused by both; data cut and then
    closed with EOI decodes in both."""
    data = cv_encode(frame(64, 80), cv2.IMWRITE_JPEG_QUALITY, 95,
                     cv2.IMWRITE_JPEG_RST_INTERVAL, interval)
    short = {"half": data[:len(data) // 2],
             "tenth_off": data[:len(data) * 9 // 10],
             "no_eoi": data[:-2], "header": data[:300],
             "half_eoi": data[:len(data) // 2] + b"\xff\xd9"}[cut]
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as f:
        f.write(short)
    want_file = cv2.imread(path)
    want = cv_decode(short)
    if want is None:
        with pytest.raises(ValueError, match="cannot decode JPEG"):
            image_io.decode_jpeg(short)
    else:
        np.testing.assert_array_equal(image_io.decode_jpeg(short), want)
    if want_file is None:
        with pytest.raises(FileNotFoundError):  # as the JAX loader raises
            image_io.read_image(path)
    else:
        np.testing.assert_array_equal(image_io.read_image(path),
                                      want_file[..., ::-1])
    # which of the two refuse is part of the contract
    assert (want is None) == (cut != "half_eoi")
    assert (want_file is None) == (cut == "header")


def exif_app1(orientation, little_endian):
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM")
            + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 2)
            + struct.pack(e + "HHIHH", 0x0110, 2, 4, 0, 0)     # a model tag
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("little_endian", [True, False])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_applied_as_imread(tmp_path, orientation,
                                            little_endian):
    """cv2 cannot write EXIF: the APP1 segment is spliced in after SOI."""
    data = cv_encode(frame(13, 21), cv2.IMWRITE_JPEG_QUALITY, 90)
    data = data[:2] + exif_app1(orientation, little_endian) + data[2:]
    path = str(tmp_path / "o.jpg")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path)[..., ::-1]
    assert want.shape[:2] == ((21, 13) if orientation >= 5 else (13, 21))
    np.testing.assert_array_equal(image_io.read_image(path), want)
    np.testing.assert_array_equal(image_io.decode_jpeg(data),
                                  cv_decode(data))


def _patch_sof(data, marker, precision=None):
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def _cmyk():
    """Headers of a four-component Adobe JPEG (what CMYK files carry)."""
    adobe = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 2])
    sof = struct.pack(">BHHB", 8, 16, 16, 4) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(4))
    return (b"\xff\xd8" + b"\xff\xee" + struct.pack(">H", len(adobe) + 2)
            + adobe + b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof
            + b"\xff\xd9")


@pytest.mark.parametrize("form", ["progressive", "arithmetic", "12-bit",
                                  "CMYK"])
def test_forms_not_ported_raise_naming_item_16(tmp_path, form):
    base = cv_encode(frame(33, 47), cv2.IMWRITE_JPEG_QUALITY, 90)
    data = {"progressive": lambda: cv_encode(
                frame(33, 47), cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
            "arithmetic": lambda: _patch_sof(base, 0xC9),
            "12-bit": lambda: _patch_sof(base, 0xC1, precision=12),
            "CMYK": _cmyk}[form]()
    with pytest.raises(NotImplementedError, match="queue A item 16"):
        image_io.decode_jpeg(data)
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(NotImplementedError, match="queue A item 16"):
        image_io.read_image(path)


@pytest.mark.parametrize("grey", [False, True])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("hw", SIZES)
def test_encoder_gives_cv2_imencode_coefficients(hw, quality, grey):
    img = frame(*hw, seed=5)
    if grey:
        img = img[..., 0]
    ours = image_io.encode_jpeg(img, quality)
    theirs = cv_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality)
    want = cv_decode(theirs)
    np.testing.assert_array_equal(cv_decode(ours), want)
    np.testing.assert_array_equal(image_io.decode_jpeg(ours), want)


def test_write_jpeg_default_quality_is_95(tmp_path):
    img = frame(40, 56, seed=3)
    path = str(tmp_path / "w.jpg")
    n = image_io.write_jpeg(path, img)
    assert n == os.path.getsize(path)
    np.testing.assert_array_equal(
        cv2.imread(path)[..., ::-1],
        cv_decode(cv_encode(img, cv2.IMWRITE_JPEG_QUALITY, 95)))
    with pytest.raises(ValueError, match="expected uint8"):
        image_io.encode_jpeg(img.astype(np.float32))


def test_digests_the_smoke_asserts():
    """The card machine has no OpenCV: chip_smoke.py holds its build of
    the encoder and decoder to these two digests, computed here against
    cv2."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    frames = chip_smoke.digest_frames()
    data = [image_io.encode_jpeg(f, 95) for f in frames]
    pixels = [cv_decode(d) for d in data]
    assert chip_smoke.sha256(data) == chip_smoke.JPEG_BYTES_SHA256
    assert chip_smoke.sha256(pixels) == chip_smoke.JPEG_PIXELS_SHA256
    for d, p in zip(data, pixels):
        np.testing.assert_array_equal(image_io.decode_jpeg(d), p)


def _bodies():
    img = frame(37, 53, seed=9)
    jpg = cv_encode(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    png = cv2.imencode(".png", img[..., ::-1])[1].tobytes()

    def js(raw, **kw):
        return json.dumps({"image": base64.b64encode(raw).decode(),
                           **kw}).encode()
    return {"raw_jpeg": jpg, "raw_png": png, "json_jpeg": js(jpg),
            "json_png": js(png),
            "json_array": js(img.tobytes(), shape=list(img.shape),
                             dtype="uint8")}


@pytest.mark.parametrize("kind", ["raw_jpeg", "raw_png", "json_jpeg",
                                  "json_png", "json_array"])
def test_serve_decode_equals_jax_without_cv2(monkeypatch, kind):
    from glsdet_tpu.serve import _decode_image as jax_decode
    from glsdet_tpu_torch.serve import _decode_image as port_decode

    body = _bodies()[kind]
    want = jax_decode(body)
    monkeypatch.setitem(sys.modules, "cv2", None)     # import cv2 raises
    got = port_decode(body)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("body", [b"GIF89a....", b"\xff\xd8\xff\xe0trunc",
                                  b"\x89PNG\r\n\x1a\nbroken"])
def test_serve_decode_refuses_what_jax_refuses(monkeypatch, body):
    from glsdet_tpu.serve import _decode_image as jax_decode
    from glsdet_tpu_torch.serve import _decode_image as port_decode

    with pytest.raises(ValueError, match="not a decodable image"):
        jax_decode(body)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match="not a decodable image"):
        port_decode(body)
