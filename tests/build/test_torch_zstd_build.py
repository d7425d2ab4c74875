"""The port's zstd decoder (``glsdet_tpu_torch/native/zstd.cpp``) builds
with the host compiler and loads: a one-block frame decodes and CRC-32C
gives its check value.

``native/build.py: build_shared`` compiles into a temporary directory and
renames the library into place, so xdist workers that build it at once
never load a half-written file; nothing needs building before they start.
"""

import os
import shutil

import pytest

from glsdet_tpu_torch.native import build


def test_zstd_library_is_built_once_and_loads():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    from glsdet_tpu_torch.native import crc32c, zstd_decompress

    # a frame of one RLE block: 5 bytes of "a", content size stated
    frame = bytes.fromhex("28b52ffd20052b000061")
    assert zstd_decompress(frame) == b"a" * 5
    assert crc32c(b"123456789") == 0xE3069283
    libs = [n for n in os.listdir(build.BUILD_DIR)
            if n.startswith("libzstd-") and n.endswith(".so")]
    assert libs
