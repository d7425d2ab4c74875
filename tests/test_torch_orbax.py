"""The port's orbax reader (``glsdet_tpu_torch/utils/orbax_read.py``)
against the JAX package, orbax and tensorstore, on the CPU:

- the committed fixture ``tests/torch_fixtures/orbax/trainstate`` read
  equal, leaf for leaf (keys, dict/list/None structure, dtypes, shapes,
  bytes; bfloat16 by its 16-bit patterns), to the JAX package's
  ``restore_raw``, and the digests ``chip_smoke.py`` holds it to
  recomputed from ``restore_raw``; its chunks hold the zstd forms the
  card machine's decoder must meet (RLE blocks, frames of several blocks,
  Huffman literals in 4 streams, FSE-coded sequence tables);
- the committed JAX two-stage archive ``two_stage.gtar`` (``coarse_det``
  and ``mp_det_res50`` at full width, stripped by the JAX ``ckpt_tool``):
  both trees equal to ``restore_raw`` and to the smoke's digests;
- OCDBT stores written by tensorstore's own ``ocdbt`` driver with nodes
  of at most 256 bytes and one commit per transaction (B+tree height
  >= 2, version tree nodes), and zarr arrays of several chunks with edge
  chunks, a missing chunk and no compressor: every key and array equal to
  tensorstore's read; a numbered manifest (orbax writes none) refused;
- orbax's ``use_ocdbt=False`` layout;
- damage and unknown layouts raise ``ValueError`` (a bad CRC-32C, a bad
  magic, zarr3, another compressor, a directory orbax did not write).

No tolerance: every comparison is exact.
"""

import hashlib
import importlib.util
import json
import os
import shutil

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

import chip_smoke
from glsdet_tpu.train.loop import restore_raw as jax_restore_raw
from glsdet_tpu_torch.train.loop import restore_raw
from glsdet_tpu_torch.utils.orbax_read import OcdbtStore, read_orbax, \
    read_zarr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "orbax")
TRAINSTATE = os.path.join(FIXTURE, "trainstate")
ARCHIVE = os.path.join(FIXTURE, "two_stage.gtar")


def assert_same_tree(got, want, path=""):
    """``got`` (read_orbax) equal to ``want`` (orbax's restore): the same
    containers and keys, None where None, the same dtypes, shapes and
    bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
            assert tuple(got.shape) == want.shape, path
            assert got.view(torch.int16).numpy().tobytes() == \
                want.view(np.int16).tobytes(), path
        else:
            assert isinstance(got, np.ndarray), path
            assert (got.dtype, got.shape) == (want.dtype, want.shape), path
            assert got.tobytes() == want.tobytes(), path


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_orbax_fixture",
        os.path.join(ROOT, "tests", "torch_fixtures", "make_orbax_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_equals_restore_raw_and_the_smoke_digests():
    want = jax_restore_raw(TRAINSTATE)
    got = read_orbax(TRAINSTATE)
    assert_same_tree(got, want)
    assert sorted(got) == ["batch_stats", "boiw", "ema_params", "opt_state",
                           "params", "rng", "step"]
    assert got["opt_state"][0] == {"inner_state": None}
    assert got["step"].dtype == np.int32 and got["step"].shape == ()
    assert got["rng"].dtype == np.uint32 and got["rng"].shape == (2,)
    tree, leaves = _generator().digests(want)
    assert tree == chip_smoke.ORBAX_FIXTURE_TREE
    assert leaves == chip_smoke.ORBAX_FIXTURE_LEAVES
    # and the smoke's own digests of the port's tree agree
    assert chip_smoke.orbax_digests(got) == (tree, leaves)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size <= 256 * 1024


def test_archive_equals_restore_raw_and_the_smoke_digests(tmp_path):
    """The committed JAX two-stage archive at full width: both trees, as
    the JAX ``load_archive`` unpacks them, read equal to ``restore_raw``,
    the smoke's digests recomputed from ``restore_raw``, and the port's
    ``load_archive`` giving the same trees."""
    import glsdet_tpu.serve as jserve
    from glsdet_tpu_torch.serve import load_archive

    manifest, dirs = jserve.load_archive(ARCHIVE, str(tmp_path / "jax"))
    pmanifest, pdirs = load_archive(ARCHIVE, str(tmp_path / "port"))
    assert manifest == pmanifest and manifest["pipeline"] == "two_stage"
    assert (manifest["config_name"], manifest["mp_config_name"]) == (
        "coarse_det", "mp_det_res50")
    gen = _generator()
    for stage, sections in (("coarse", ["batch_stats", "params"]),
                            ("mp", ["batch_stats", "boiw", "params"])):
        want = jax_restore_raw(dirs[stage])
        got = read_orbax(pdirs[stage])
        assert sorted(got) == sections
        assert_same_tree(got, want)
        tree, leaves = gen.digests(want)
        lines = "\n".join(f"{k} {v}" for k, v in sorted(leaves.items()))
        pair = [tree, hashlib.sha256(lines.encode()).hexdigest()]
        assert pair == chip_smoke.ORBAX_ARCHIVE_DIGESTS[stage], stage
        assert chip_smoke.orbax_tree_digests(got) == pair


def zstd_forms(frame: bytes) -> set:
    """The block, literal and sequence-table forms of a zstd frame, read
    from its headers (RFC 8878 sections 3.1.1.2-3.1.1.3)."""
    forms, pos = set(), 4
    desc = frame[pos]
    pos += 1 + (0 if desc & 0x20 else 1)
    pos += [0, 1, 2, 4][desc & 3] + [desc & 0x20 and 1, 2, 4, 8][desc >> 6]
    blocks = 0
    while True:
        head = int.from_bytes(frame[pos:pos + 3], "little")
        last, btype, size = head & 1, (head >> 1) & 3, head >> 3
        pos += 3
        blocks += 1
        forms.add(("block", ["raw", "rle", "compressed"][btype]))
        if btype == 2:
            b = frame[pos:pos + size]
            ltype, sf = b[0] & 3, (b[0] >> 2) & 3
            forms.add(("literals", ["raw", "rle", "huffman", "treeless"]
                       [ltype], 1 if ltype >= 2 and sf == 0 else 4
                       if ltype >= 2 else 0))
            if ltype < 2:
                lsec = [1, 2, 1, 3][sf] + ([b[0] >> 3, (b[0] >> 4)
                                            + (b[1] << 4), b[0] >> 3,
                                            (b[0] >> 4) + (b[1] << 4)
                                            + (b[2] << 12)][sf]
                                           if ltype == 0 else 1)
            else:
                hs = [3, 3, 4, 5][sf]
                bits = [10, 10, 14, 18][sf]
                h = int.from_bytes(b[:hs], "little")
                lsec = hs + ((h >> (4 + bits)) & ((1 << bits) - 1))
            q = b[lsec:]
            nseq = q[0] if q[0] < 128 else None
            if q[0] >= 128 or nseq:
                at = 1 if q[0] < 128 else 2 if q[0] < 255 else 3
                modes = q[at]
                for shift, table in ((6, "ll"), (4, "of"), (2, "ml")):
                    forms.add(("table", table, ["predefined", "rle", "fse",
                                                "repeat"][(modes >> shift)
                                                          & 3]))
        pos += 1 if btype == 1 else size
        if last:
            break
    if blocks > 1:
        forms.add(("blocks", "several"))
    return forms


def test_fixture_chunks_hold_the_forms_the_decoder_must_meet():
    forms = set()
    with OcdbtStore(TRAINSTATE) as store:
        for key in store.keys():
            if not key.endswith(b".zarray"):
                forms |= zstd_forms(store.get(key.decode()))
    for form in [("block", "rle"), ("block", "compressed"),
                 ("blocks", "several"), ("literals", "huffman", 4),
                 ("table", "ml", "fse"), ("table", "of", "fse"),
                 ("table", "ll", "predefined")]:
        assert form in forms, (form, sorted(forms))


def _ts_store(base: str, **config):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{base}/",
                            "config": config}).result()


def test_tensorstore_ocdbt_trees_and_zarr_arrays(tmp_path):
    base = str(tmp_path / "deep")
    kv = _ts_store(base, max_decoded_node_bytes=256,
                   version_tree_arity_log2=1, max_inline_value_bytes=16)
    rs = np.random.RandomState(0)
    for _ in range(6):          # six commits: version tree nodes
        with ts.Transaction() as txn:
            for _ in range(40):
                key = f"layer{rs.randint(30):02d}/w{rs.randint(1000):04d}"
                kv.with_transaction(txn)[key.encode()] = rs.bytes(
                    rs.randint(0, 60))
    arrays = [("f4", "<f4", (37, 23), (16, 10), "zstd"),
              ("bf", "bfloat16", (9, 5), (4, 4), "zstd"),
              ("i8", "<i8", (11,), (4,), "zstd"),
              ("u1", "|u1", (5, 6, 7), (2, 3, 4), "zstd"),
              ("u4", "<u4", (10, 3), (4, 2), None),
              ("b1", "|b1", (6, 5), (4, 4), "zstd"),
              ("f8", "<f8", (), (), "zstd")]
    for name, dtype, shape, chunks, comp in arrays:
        arr = ts.open({
            "driver": "zarr", "create": True,
            "kvstore": {"driver": "ocdbt", "base": f"file://{base}/",
                        "path": f"{name}/"},
            "metadata": {"dtype": dtype, "shape": list(shape),
                         "chunks": list(chunks),
                         "compressor": comp and {"id": "zstd", "level": 3},
                         "fill_value": True if dtype == "|b1" else 7,
                         "dimension_separator": "/" if name == "u1"
                         else "."}}).result()
        vals = np.asarray(rs.randn(*shape) * 100)
        arr[...] = vals.astype(arr.dtype.numpy_dtype)
    with ts.Transaction() as txn:       # a missing chunk: the fill value
        del kv.with_transaction(txn)[b"f4/0.0"]
    dump = ts.ocdbt.dump(ts.KvStore.open(
        {"driver": "file", "path": base + "/"}).result()).result()
    assert dump["versions"][-1]["root_height"] >= 2
    assert dump["version_tree_nodes"]
    keys = kv.list().result()
    with OcdbtStore(base) as store:
        assert store.keys() == sorted(keys)
        for key in keys:
            assert store.get(key.decode()) == kv.read(key).result().value
        for name, dtype, *_ in arrays:
            want = ts.open({"driver": "zarr", "kvstore": {
                "driver": "ocdbt", "base": f"file://{base}/",
                "path": f"{name}/"}}).result().read().result()
            got = read_zarr(store.get, name)
            if dtype == "bfloat16":
                got = got.view(torch.int16).numpy()
                want = want.view(np.int16)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), name
        assert (read_zarr(store.get, "f4")[:16, :10] == 7).all()
    # a numbered manifest, which orbax does not write, is refused by name
    numbered = str(tmp_path / "numbered")
    kv = _ts_store(numbered, manifest_kind="numbered")
    kv.write("k0", b"v").result()
    with pytest.raises(ValueError, match="manifest_kind 1"):
        OcdbtStore(numbered)


def test_orbax_without_ocdbt(tmp_path):
    tree = {"a": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)},
            "l": [np.int32(3), np.ones((70000,), np.int64)],
            "bf": jax.numpy.asarray([1.5, -2.25], jax.numpy.bfloat16),
            "n": None, "e": {}}
    path = str(tmp_path / "plain")
    ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False))
    ckptr.save(path, args=ocp.args.PyTreeSave(jax.tree.map(np.asarray,
                                                           tree)))
    with open(os.path.join(path, "_METADATA")) as f:
        assert json.load(f)["use_ocdbt"] is False
    assert_same_tree(read_orbax(path), jax_restore_raw(path))


def _copy(tmp_path):
    dst = str(tmp_path / "ckpt")
    shutil.copytree(TRAINSTATE, dst)
    return dst


def _flip(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x10]))


def test_damage_and_unknown_layouts_raise(tmp_path):
    path = _copy(tmp_path)
    manifest = os.path.join(path, "manifest.ocdbt")
    _flip(manifest, 20)
    with pytest.raises(ValueError, match="CRC-32C"):
        read_orbax(path)
    shutil.rmtree(path)
    path = _copy(tmp_path)
    _flip(os.path.join(path, "manifest.ocdbt"), 0)
    with pytest.raises(ValueError, match="bad magic"):
        read_orbax(path)
    shutil.rmtree(path)
    path = _copy(tmp_path)
    (node,) = os.listdir(os.path.join(path, "d"))   # the root B+tree node
    _flip(os.path.join(path, "d", node), 30)
    with pytest.raises(ValueError, match="CRC-32C"):
        read_orbax(path)
    shutil.rmtree(path)
    path = _copy(tmp_path)
    meta_path = os.path.join(path, "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    with open(meta_path, "w") as f:
        json.dump(dict(meta, use_zarr3=True), f)
    with pytest.raises(ValueError, match="use_zarr3 = True"):
        read_orbax(path)
    # a directory orbax did not write, through the port's restore_raw
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="_METADATA"):
        restore_raw(str(empty))


def test_unknown_compressor_and_order_raise():
    meta = {"zarr_format": 2, "shape": [4], "chunks": [4], "dtype": "<f4",
            "compressor": {"id": "blosc"}, "fill_value": None,
            "order": "C", "filters": None}

    def store(m):
        return {"x/.zarray": json.dumps(m).encode()}.get

    with pytest.raises(ValueError, match="compressor"):
        read_zarr(store(meta), "x")
    with pytest.raises(ValueError, match="order = 'F'"):
        read_zarr(store(dict(meta, compressor=None, order="F")), "x")
    got = read_zarr(store(dict(meta, compressor=None, fill_value="NaN")),
                    "x")
    assert np.isnan(got).all() and got.dtype == np.float32
