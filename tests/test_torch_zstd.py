"""The port's zstd decoder (``glsdet_tpu_torch/native/zstd.cpp``, bound in
``glsdet_tpu_torch/native/__init__.py``) against the ``zstandard``
package (the reference zstd library) on the same frames: equal byte for
byte, at levels -7, 1, 3, 9, 19 and 22, sizes 0 B to 2 MiB of random,
zero, repeated and float32 weight-like bytes, with the content checksum on
and off and the content size stated or not; frames back to back and
skippable frames.  Damaged frames (cut short, a bit flipped, a flipped
checksum) raise ``ValueError``, and never return other bytes where the
frame carries a checksum.  CRC-32C against its check value and a bitwise
reference.
"""

import io

import numpy as np
import pytest
import zstandard

from glsdet_tpu_torch.native import (crc32c, zstd_decompress,
                                     zstd_decompress_into)

LEVELS = [-7, 1, 3, 9, 19, 22]
SIZES = [0, 1, 7, 100, 4096, 70000, 131072, 131073, 300000]
BIG = 2 << 20
FLAGS = [(False, False), (False, True), (True, False), (True, True)]


def payload(kind: str, size: int, seed: int = 0) -> bytes:
    rs = np.random.RandomState(seed + size)
    if kind == "random":
        return rs.bytes(size)
    if kind == "zero":
        return bytes(size)
    if kind == "repeated":
        row = rs.bytes(37) + bytes(11)
        return (row * (size // len(row) + 1))[:size]
    # float32 weights: normal draws, a few exact repeats and zero runs
    w = (rs.randn(size // 4 + 1) * 0.02).astype(np.float32)
    w[::17] = 0
    w[5::29] = w[4::29][:len(w[5::29])]
    return w.tobytes()[:size]


def reference(frames: bytes) -> bytes:
    reader = zstandard.ZstdDecompressor().stream_reader(
        io.BytesIO(frames), read_across_frames=True)
    return reader.read()


@pytest.mark.parametrize("kind", ["random", "zero", "repeated", "float32"])
@pytest.mark.parametrize("level", LEVELS)
def test_equal_to_zstandard(level, kind):
    cases = [(size, flags) for size in SIZES for flags in FLAGS]
    cases.append((BIG, (True, False)))      # 2 MiB, streamed size unknown
    for size, (checksum, content_size) in cases:
        data = payload(kind, size)
        frame = zstandard.ZstdCompressor(
            level=level, write_checksum=checksum,
            write_content_size=content_size).compress(data)
        want = reference(frame)
        assert want == data
        what = (level, kind, size, checksum, content_size)
        assert zstd_decompress(frame) == want, what
        out = np.empty(size, np.uint8)
        assert zstd_decompress_into(frame, out) == size, what
        assert out.tobytes() == want, what


def test_frames_back_to_back_and_skippable():
    a = payload("float32", 50000)
    b = payload("repeated", 140000, seed=1)
    fa = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(a)
    fb = zstandard.ZstdCompressor(level=19,
                                  write_content_size=False).compress(b)
    skip = (0x184D2A5B).to_bytes(4, "little") + (6).to_bytes(4, "little") \
        + b"orbax!"
    for frames in (fa + fb, fb + fa, skip + fa + skip + fb, fa + skip):
        assert zstd_decompress(frames) == reference(frames)
    # the stated sizes of every frame size the output
    fc = zstandard.ZstdCompressor(level=1).compress(b)
    assert zstd_decompress(fa + fc) == a + b


def test_streamed_frames_of_several_blocks():
    """A frame written by a stream (no content size, blocks of less than
    128 KiB, a small window) decodes like one written at once."""
    data = payload("float32", 600000)
    cctx = zstandard.ZstdCompressor(level=3, write_checksum=True)
    buf = io.BytesIO()
    with cctx.stream_writer(buf, closefd=False) as w:
        for i in range(0, len(data), 20000):
            w.write(data[i:i + 20000])
            w.flush()
    frame = buf.getvalue()
    assert zstd_decompress(frame) == data == reference(frame)
    small = zstandard.ZstdCompressor(
        compression_params=zstandard.ZstdCompressionParameters(
            window_log=10, compression_level=5)).compress(data)
    assert zstd_decompress(small) == data


@pytest.mark.parametrize("checksum", [False, True])
def test_damaged_frames_raise(checksum):
    rs = np.random.RandomState(3)
    raised = 0
    for kind, size in (("float32", 3000), ("repeated", 200000),
                       ("random", 5000)):
        data = payload(kind, size)
        frame = zstandard.ZstdCompressor(
            level=3, write_checksum=checksum).compress(data)
        out = np.empty(size, np.uint8)
        for cut in sorted(set(rs.randint(1, len(frame), 12).tolist())
                          | {len(frame) - 1, 3}):
            with pytest.raises(ValueError, match="at byte"):
                zstd_decompress_into(frame[:cut], out)
        for _ in range(40):
            bad = bytearray(frame)
            i = rs.randint(4, len(bad))
            bad[i] ^= 1 << rs.randint(0, 8)
            try:
                got = out[:zstd_decompress_into(bytes(bad), out)].tobytes()
            except ValueError:
                raised += 1
                continue
            # a frame without a checksum may decode damaged bytes to other
            # bytes of the right length; one with a checksum never does
            assert not checksum or got == data, (kind, i)
    # literals and raw blocks take most flips silently without a checksum
    assert raised >= 10
    if checksum:
        frame = bytearray(frame)
        frame[-1] ^= 0x40
        with pytest.raises(ValueError, match="checksum"):
            zstd_decompress(bytes(frame))


def test_refusals():
    frame = zstandard.ZstdCompressor(level=1).compress(b"x" * 1000)
    with pytest.raises(ValueError, match="more than 999"):
        zstd_decompress_into(frame, np.empty(999, np.uint8))
    with pytest.raises(ValueError, match="magic"):
        zstd_decompress(b"\x00" * 16)
    with pytest.raises(ValueError, match="no zstd frame"):
        zstd_decompress(b"")
    # a frame naming dictionary 7 (descriptor: 1-byte dictionary id)
    named = bytearray(frame[:4]) + bytes([frame[4] | 1]) + frame[5:6] \
        + b"\x07" + frame[6:]
    with pytest.raises(ValueError, match="dictionary"):
        zstd_decompress(bytes(named))


def test_crc32c():
    assert crc32c(b"123456789") == 0xE3069283
    data = np.random.RandomState(0).bytes(1000)

    def bitwise(buf, crc=0):
        crc ^= 0xFFFFFFFF
        for byte in buf:
            crc ^= byte
            for _ in range(8):
                crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        return crc ^ 0xFFFFFFFF

    for n in (0, 1, 7, 8, 9, 1000):
        assert crc32c(data[:n]) == bitwise(data[:n])
    assert crc32c(data[500:], crc32c(data[:500])) == crc32c(data)
