"""Every PNG form the port reads (``data/image_io.py: decode_png``)
against ``cv2.imread`` (IMREAD_COLOR) after BGR -> RGB, on synthetic
files written here: Adam7 interlacing, palettes (with ``tRNS``, which
IMREAD_COLOR drops, and indices past the palette), grey+alpha, bit
depths 1, 2, 4 and 16, every filter type."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from glsdet_tpu_torch.data import image_io

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def pack_rows(samples, depth):
    """(rows, cols) samples -> (rows, stride) bytes at ``depth`` bits."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(
            samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    rows, cols = samples.shape
    padded = np.zeros((rows, -(-cols // per) * per), np.uint16)
    padded[:, :cols] = samples
    shifts = np.arange(8 - depth, -1, -depth)
    grouped = padded.reshape(rows, -1, per) << shifts
    return grouped.sum(-1).astype(np.uint8)


def filter_rows(raw, bpp, rs):
    """Each row under a random filter type (0-4), as an encoder may."""
    x = raw.astype(np.int16)
    h, stride = x.shape
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cands = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth])
    kind = rs.randint(0, 5, h)
    out = np.empty((h, stride + 1), np.uint8)
    out[:, 0] = kind
    out[:, 1:] = (cands[kind, np.arange(h)] & 0xFF).astype(np.uint8)
    return out


def png_bytes(samples, depth, ctype, interlace, rs, palette=None,
              trns=None):
    """A PNG of (H, W, C) ``samples`` at ``depth`` bits, colour type
    ``ctype``, optionally Adam7-interlaced."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        raw = pack_rows(sub.reshape(sub.shape[0], -1), depth)
        data += filter_rows(raw, bpp, rs).tobytes()
    out = (image_io.PNG_SIGNATURE
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                        0, int(interlace))))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    z = zlib.compress(data)
    half = len(z) // 2                          # IDAT split in two
    return (out + chunk(b"IDAT", z[:half]) + chunk(b"IDAT", z[half:])
            + chunk(b"IEND", b""))


FORMS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
         (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (13, 17), (33, 47)])
@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", FORMS)
def test_png_form_equals_cv2_imread(tmp_path, ctype, depth, interlace, hw):
    rs = np.random.RandomState(ctype * 100 + depth * 10 + hw[1])
    h, w = hw
    ch = CHANNELS[ctype]
    palette = trns = None
    if ctype == 3:
        n = min(1 << depth, 200)
        palette = rs.randint(0, 256, (n - 1 if depth > 1 else n, 3))
        trns = bytes(rs.randint(0, 256, min(4, len(palette))).tolist())
        top = 1 << depth                  # indices past the palette too
    else:
        top = 1 << depth
    samples = rs.randint(0, top, (h, w, ch)).astype(np.uint32)
    data = png_bytes(samples, depth, ctype, interlace, rs, palette, trns)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert want is not None
    got = image_io.read_image(path)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want[..., ::-1])
    assert image_io.image_size(path) == (w, h)
