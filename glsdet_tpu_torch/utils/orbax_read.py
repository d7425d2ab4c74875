"""Reading the JAX package's orbax checkpoints without JAX, orbax or
tensorstore: the counterpart of ``glsdet_tpu/train/loop.py: restore_raw``.

``orbax.checkpoint.StandardCheckpointer`` writes a directory with
``_METADATA`` (JSON: the layout flags and ``tree_metadata``, one entry per
leaf with its key path) and the arrays, as zarr v2 arrays named by the
leaf's key path joined with ``.``:

- ``use_ocdbt: true`` (orbax's default): the arrays are keys of an OCDBT
  key-value store rooted at the directory (``manifest.ocdbt``, B+tree
  nodes and data files under ``d/`` and ``ocdbt.process_<n>/d/``), read
  here as tensorstore's OCDBT format documentation describes it: the
  manifest (its config, data file table and inline version tree, whose
  last entry is the newest generation; orbax writes the ``single``
  manifest kind, and another raises), B+tree nodes of any height with
  prefix-compressed keys (an interior entry's key is its subtree's least
  key; its ``subtree_common_prefix`` is stripped from every key below
  it), values inline in the leaves or at an offset and length of a data
  file.  Every manifest and node is checked for its magic, its stated
  length, format version 0 and its trailing CRC-32C, and is read to its
  last byte;
- ``use_ocdbt: false``: each array is a directory of files.

A zarr array is ``<name>/.zarray`` (shape, chunks, dtype, compressor
``zstd`` or none, C order, separator ``.`` or ``/``, fill value) and one
key per chunk (``<name>/0.0``; ``<name>/0`` for a 0-d array); edge chunks
are cropped and missing chunks hold the fill value (zeros for ``null``).
zstd frames are decoded by ``native/zstd.cpp``.

:func:`read_orbax` rebuilds the tree from ``tree_metadata``'s key
metadata (a dict key, ``key_type`` 2, or a sequence index, 1): dicts and
lists, ``None`` (and empty dicts and lists) where the value type says so.
Array leaves are numpy arrays, except bfloat16 ones, which numpy lacks:
they are ``torch.bfloat16`` tensors on the CPU, bit for bit.  A layout
this reader does not know (zarr3, another compressor, F order, filters, an
unknown value or key type) raises ``ValueError`` naming the field and its
value; no partial tree is returned.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from glsdet_tpu_torch.native import crc32c, zstd_decompress, \
    zstd_decompress_into

METADATA = "_METADATA"
MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1        # offset and length of an empty tree's root
_KEY_DICT, _KEY_SEQUENCE = 2, 1
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list}


class _Bytes:
    """A cursor over one decoded manifest or node; reading past its end
    raises ``ValueError`` naming ``what``."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n > len(self.data) - self.pos:
            raise ValueError(f"{self.what}: truncated at byte {self.pos}")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def byte(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long at byte "
                                 f"{self.pos}")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} "
                             "bytes left over")


def _envelope(data: bytes, magic: int, what: str) -> _Bytes:
    """The body of an encoded manifest or node: magic (big-endian u32),
    total length (u64), format version and compression (varints), the
    body, zstd-compressed or not, and the CRC-32C of everything before
    it."""
    if len(data) < 18:
        raise ValueError(f"{what}: {len(data)} bytes, too short")
    (got,) = struct.unpack(">I", data[:4])
    if got != magic:
        raise ValueError(f"{what}: bad magic {got:#010x} (want "
                         f"{magic:#010x})")
    (length,) = struct.unpack("<Q", data[4:12])
    if length != len(data):
        raise ValueError(f"{what}: states {length} bytes, has {len(data)}")
    (crc,) = struct.unpack("<I", data[-4:])
    if crc32c(data[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    head = _Bytes(data[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version} is not read")
    body = head.data[head.pos:]
    if compression == 1:
        body = zstd_decompress(body)
    elif compression != 0:
        raise ValueError(f"{what}: compression {compression} is not read")
    return _Bytes(body, what)


def _data_file_table(r: _Bytes, transitive: str) -> List[Tuple[str, str]]:
    """The data files a manifest or node refers to, as (base path,
    relative path); each path is prefix-compressed against the previous
    one, and the base path of the file the node itself was read from
    (``transitive``) comes before each base path."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev) or base_len[i] > prefix[i] + suffix[i]:
            raise ValueError(f"{r.what}: bad data file table")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        path = prev.decode()
        files.append((transitive + path[:base_len[i]], path[base_len[i]:]))
    return files


def _locations(r: _Bytes, files: List[Tuple[str, str]], n: int):
    """``n`` (base path, relative path, offset, length) references; None
    for the missing location of an empty tree."""
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    out = []
    for i, off, ln in zip(ids, offsets, lengths):
        if off == _MISSING and ln == _MISSING:
            out.append(None)
            continue
        if i >= len(files):
            raise ValueError(f"{r.what}: data file {i} of {len(files)}")
        out.append((*files[i], off, ln))
    return out


class OcdbtStore:
    """A read-only view of an OCDBT store's newest generation:
    ``keys()``, ``get(key) -> bytes | None`` (from any thread).  Data
    files are read with ``os.pread`` and closed by :meth:`close` (or the
    ``with`` block)."""

    def __init__(self, root: str):
        self.root = root
        self._fds: Dict[str, int] = {}
        self._fd_lock = threading.Lock()
        self._values: Dict[bytes, object] = {}
        try:
            self._open()
        except BaseException:
            self.close()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def _read(self, ref: Tuple[str, str, int, int]) -> bytes:
        base, rel, off, ln = ref
        path = base + rel
        parts = path.split("/")
        if path.startswith("/") or ".." in parts:
            raise ValueError(f"{self.root}: data file {path!r} leaves the "
                             "store")
        with self._fd_lock:
            fd = self._fds.get(path)
            if fd is None:
                fd = self._fds[path] = os.open(os.path.join(self.root, path),
                                               os.O_RDONLY)
        data = os.pread(fd, ln, off)
        if len(data) != ln:
            raise ValueError(f"{self.root}/{path}: {ln} bytes at {off} "
                             f"requested, {len(data)} present")
        return data

    def _manifest(self) -> _Bytes:
        with open(os.path.join(self.root, MANIFEST), "rb") as f:
            r = _envelope(f.read(), MANIFEST_MAGIC, MANIFEST)
        r.take(16)                                  # uuid
        kind = r.varint()
        if kind != 0:       # 1: "numbered", which orbax does not write
            raise ValueError(f"{self.root}: manifest_kind {kind} is not read")
        r.varint()                                  # max_inline_value_bytes
        r.varint()                                  # max_decoded_node_bytes
        r.byte()                                    # version_tree_arity_log2
        compression = r.varint()
        if compression == 1:
            r.take(4)                               # zstd level, int32
        elif compression != 0:
            raise ValueError(f"{self.root}: manifest compression "
                             f"{compression} is not read")
        return r

    def _open(self) -> None:
        r = self._manifest()
        files = _data_file_table(r, "")
        n = r.varint()
        if n == 0:
            raise ValueError(f"{self.root}: manifest holds no version")
        generations = r.varints(n)
        heights = [r.byte() for _ in range(n)]
        roots = _locations(r, files, n)
        r.varints(3 * n)        # num_keys, num_tree_bytes, indirect bytes
        for _ in range(n):
            r.u64()                                 # commit_time
        # the version tree nodes hold the older generations only
        m = r.varint()
        r.varints(m)                                # generation numbers
        _locations(r, files, m)
        r.varints(m)                                # num_generations
        for _ in range(m):
            r.u64()                                 # commit_time
        for _ in range(m):
            r.byte()                                # height
        r.end()
        newest = int(np.argmax(generations))
        if roots[newest] is not None:
            self._node(roots[newest], heights[newest], b"")

    def _node(self, ref, height: int, prefix: bytes) -> None:
        what = f"B+tree node {ref[0]}{ref[1]}@{ref[2]}"
        r = _envelope(self._read(ref), BTREE_MAGIC, what)
        if r.byte() != height:
            raise ValueError(f"{what}: height differs from its reference")
        files = _data_file_table(r, ref[0])
        n = r.varint()
        if n == 0:
            raise ValueError(f"{what}: empty node")
        kprefix = [0] + r.varints(n - 1)
        ksuffix = r.varints(n)
        common = r.varints(n) if height > 0 else None
        keys, prev = [], b""
        for i in range(n):
            if kprefix[i] > len(prev):
                raise ValueError(f"{what}: bad key prefix")
            prev = prev[:kprefix[i]] + r.take(ksuffix[i])
            keys.append(prev)
        if any(a >= b for a, b in zip(keys, keys[1:])):
            raise ValueError(f"{what}: keys out of order")
        if height > 0:
            children = _locations(r, files, n)
            r.varints(3 * n)    # num_keys, num_tree_bytes, indirect bytes
            r.end()
            for key, c, child in zip(keys, common, children):
                if child is None or c > len(key):
                    raise ValueError(f"{what}: bad child reference")
                self._node(child, height - 1, prefix + key[:c])
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            raise ValueError(f"{what}: unknown value kind")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        for j, i in enumerate(indirect):
            if ids[j] >= len(files):
                raise ValueError(f"{what}: data file {ids[j]} of "
                                 f"{len(files)}")
            self._values[prefix + keys[i]] = (*files[ids[j]], offsets[j],
                                              lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                self._values[prefix + keys[i]] = r.take(lengths[i])
        r.end()

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def get(self, key: str) -> Optional[bytes]:
        value = self._values.get(key.encode())
        if value is None or isinstance(value, bytes):
            return value
        return self._read(value)


def _file_get(root: str) -> Callable[[str], Optional[bytes]]:
    def get(key: str) -> Optional[bytes]:
        parts = key.split("/")
        if ".." in parts or key.startswith("/"):
            raise ValueError(f"{root}: key {key!r} leaves the checkpoint")
        path = os.path.join(root, *parts)
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()
    return get


def _fill(meta: dict, dtype: np.dtype, bf16: bool):
    fill = meta.get("fill_value")
    if fill is None:
        return 0
    if isinstance(fill, str):
        fill = {"NaN": float("nan"), "Infinity": float("inf"),
                "-Infinity": float("-inf")}.get(fill)
        if fill is None:
            raise ValueError(f"fill_value {meta['fill_value']!r} is not read")
    if bf16:
        return int(torch.tensor(fill, dtype=torch.bfloat16)
                   .view(torch.int16).item()) & 0xFFFF
    return np.asarray(fill).astype(dtype)


def read_zarr(get: Callable[[str], Optional[bytes]], name: str):
    """The zarr v2 array ``name`` of a key-value store read through
    ``get(key) -> bytes | None``: a numpy array, or a ``torch.bfloat16``
    tensor for dtype ``bfloat16``."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise ValueError(f"array {name!r}: no .zarray")
    meta = json.loads(raw)

    def refuse(field):
        raise ValueError(f"array {name!r}: {field} = {meta.get(field)!r} "
                         "is not read")

    if meta.get("zarr_format") != 2:
        refuse("zarr_format")
    if meta.get("order", "C") != "C":
        refuse("order")
    if meta.get("filters"):
        refuse("filters")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        refuse("compressor")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        refuse("dimension_separator")
    bf16 = meta.get("dtype") == "bfloat16"
    try:
        dtype = np.dtype(np.uint16 if bf16 else meta.get("dtype"))
    except TypeError:
        refuse("dtype")
    if dtype.kind not in "biuf":
        refuse("dtype")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        refuse("chunks")
    out = np.full(shape, _fill(meta, dtype, bf16), dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = get(key)
        if data is None:
            continue
        if comp is None:
            chunk = np.frombuffer(data, dtype)
            if chunk.nbytes != nbytes:
                raise ValueError(f"{key}: {chunk.nbytes} bytes, want "
                                 f"{nbytes}")
        else:
            chunk = np.empty(nbytes // dtype.itemsize, dtype)
            if zstd_decompress_into(data, chunk) != nbytes:
                raise ValueError(f"{key}: decodes to fewer than {nbytes} "
                                 "bytes")
        chunk = chunk.reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    out = out.astype(dtype.newbyteorder("="), copy=False)
    if bf16:
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def _insert(root: dict, path, value) -> None:
    """Place ``value`` at ``path`` (``(key, key_type)`` pairs) in nested
    dicts; a sequence level is a dict of int keys turned into a list
    later."""
    node = root
    for (key, kt), (_, next_kt) in zip(path, path[1:]):
        k = int(key) if kt == _KEY_SEQUENCE else key
        child = node.setdefault(k, ({}, next_kt))
        if child[1] != next_kt:
            raise ValueError(f"key {key!r} is both a dict and a sequence")
        node = child[0]
    key, kt = path[-1]
    node[int(key) if kt == _KEY_SEQUENCE else key] = (value, None)


def _build(node: dict, kind):
    out = {k: (_build(v, t) if t is not None else v)
           for k, (v, t) in node.items()}
    if kind != _KEY_SEQUENCE:
        return out
    if sorted(out) != list(range(len(out))):
        raise ValueError(f"sequence indices {sorted(out)} are not 0..n-1")
    return [out[i] for i in range(len(out))]


def read_orbax(path: str) -> dict:
    """The tree an orbax ``StandardCheckpointer`` saved at ``path``:
    nested dicts and lists, ``None`` leaves, numpy arrays and
    ``torch.bfloat16`` tensors (see the module's docstring)."""
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path} is a directory without {METADATA}: an "
                         "orbax checkpoint directory (_METADATA beside "
                         "manifest.ocdbt or its arrays) or a checkpoint file "
                         "was expected")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: use_zarr3 = {meta['use_zarr3']!r} is not "
                         "read (zarr v2 only)")
    tree = meta.get("tree_metadata")
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: {METADATA} has no tree_metadata")
    store = OcdbtStore(path) if meta.get("use_ocdbt", True) else None
    try:
        get = store.get if store is not None else _file_get(path)
        leaves, arrays = [], []
        for entry in tree.values():
            keys = entry["key_metadata"]
            kinds = [k["key_type"] for k in keys]
            bad = [k for k in kinds if k not in (_KEY_DICT, _KEY_SEQUENCE)]
            if bad or not keys:
                raise ValueError(f"{path}: key_type {bad} is not read")
            vtype = entry["value_metadata"]["value_type"]
            if vtype not in _EMPTY and vtype != "np.ndarray":
                raise ValueError(f"{path}: value_type {vtype!r} is not read")
            leaves.append(([(str(k["key"]), k["key_type"]) for k in keys],
                           vtype))
            if vtype == "np.ndarray":
                arrays.append(".".join(str(k["key"]) for k in keys))
        # the decoder releases the GIL: arrays decode on every core
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            values = iter(list(pool.map(lambda n: read_zarr(get, n),
                                        arrays)))
        root: dict = {}
        for keys, vtype in leaves:
            value = next(values) if vtype == "np.ndarray" \
                else _EMPTY[vtype]()
            _insert(root, keys, value)
        return _build(root, _KEY_DICT)
    finally:
        if store is not None:
            store.close()
