"""Writes the JAX checkpoints of ``tests/torch_fixtures/orbax``, which
``chip_smoke.py`` reads on the GPU machine, where there is no JAX, and
``tests/test_torch_orbax.py`` holds to ``restore_raw`` here:
``trainstate``, a small JAX ``TrainState`` saved by the JAX package's own
``save_checkpoint`` (orbax, OCDBT, zarr v2, zstd), and
``two_stage.gtar``, a two-stage archive of the JAX ``serve.archive_model``
holding ``coarse_det`` and ``mp_det_res50`` at full width.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_orbax_fixture.py \
        [trainstate] [two_stage]

The state is shaped like a training run's: ``params`` / ``ema_params`` of
a two-block conv net with a Dense head (``stem``, ``body``: ``conv`` +
``bn``; ``head`` in bfloat16; a 0-d ``scale``), ``batch_stats``, the
``yolox_sgd`` optimizer state after two steps (lists, a ``None`` leaf,
the momentum trace, the count), a uint32 ``rng``, a 0-d int32 ``step``
and a BoIW dictionary.  The leaves are chosen for the zstd decoder: the
(3, 3, 64, 64) float32 body kernel (147,456 bytes, more than one 128 KiB
block) repeats a few rows (long matches, repeat offsets), the all-zero
BoIW dictionary (153,600 bytes) makes RLE blocks, the stem kernel is
noise (Huffman-coded literals).  Prints the digests ``chip_smoke.py``
holds the fixture to (``ORBAX_FIXTURE_TREE``, ``ORBAX_FIXTURE_LEAVES``).

The archive's two trees are artifacts of the JAX ``tools/ckpt_tool.py
strip`` (``params`` and ``batch_stats``; MP-Det's also ``boiw``) of the
full-width models.  Seeded weights barely compress and orbax's
``_METADATA`` alone is some 250 KB of JSON, so the weights are of low
entropy (:func:`pattern_variables`) and the archive's zip deflates the
JSON: the archive is about 160 KB.  One kernel, ``head/stem0``
(1x1, 128 -> 128, 65,536 bytes), is seeded noise: the weight-like chunk
the smoke times the decoder on.  MP-Det's BoIW embedding (2.25 MB) is all
zero (RLE blocks).  Prints the digests of both trees
(``ORBAX_ARCHIVE_DIGESTS``: the key/dtype/shape list and the sha256 of
every leaf's bytes, one sha256 over them all).

Not run by the tests: it needs JAX and orbax, and rewrites the committed
files (new UUIDs and times, the same arrays).
"""

import argparse
import importlib.util
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import glsdet_tpu.serve as jserve  # noqa: E402
from glsdet_tpu.config import get_config  # noqa: E402
from glsdet_tpu.train import TrainState, init_boiw, yolox_sgd, \
    yolox_warm_cos  # noqa: E402
from glsdet_tpu.train.loop import build_model, restore_raw, \
    save_checkpoint  # noqa: E402
from glsdet_tpu.train.state import apply_updates  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "orbax")
OUT = os.path.join(FIXTURES, "trainstate")
ARCHIVE = os.path.join(FIXTURES, "two_stage.gtar")
PERIOD = 7            # values a low-entropy leaf repeats
# a pattern kernel is KERNEL_GAIN[config] * pattern / fan-in
KERNEL_GAIN = {"coarse_det": 6.5, "mp_det_res50": 3.0}
NOISE = ("head/stem0/conv/kernel",)
ARCHIVE_THR = 1e-4    # the archive's score_thr and coarse_score_thr


def fixture_state() -> TrainState:
    rs = np.random.RandomState(0)
    base = rs.randn(3, 3, 64).astype(np.float32)
    levels = np.float32([0.5, -1.0, 0.25, 2.0, -0.125, 1.5, 0.75])
    body = base[..., None] * levels[np.arange(64) % 7]   # repeated rows
    params = {
        "stem": {"conv": {"kernel": rs.randn(3, 3, 3, 16).astype(np.float32)},
                 "bn": {"scale": np.ones(16, np.float32),
                        "bias": np.zeros(16, np.float32)}},
        "body": {"conv": {"kernel": body},
                 "bn": {"scale": np.ones(64, np.float32),
                        "bias": np.zeros(64, np.float32)}},
        "head": {"kernel": jnp.asarray(rs.randn(64, 10) * 0.1, jnp.bfloat16),
                 "bias": jnp.zeros(10, jnp.bfloat16)},
        "scale": np.float32(1.0),
    }
    stats = {blk: {"bn": {"mean": np.zeros(c, np.float32),
                          "var": np.ones(c, np.float32)}}
             for blk, c in (("stem", 16), ("body", 64))}
    tx = yolox_sgd(yolox_warm_cos(0.01, 10, 100, 10))
    key = jax.random.PRNGKey(0)
    boiw = init_boiw(key, 2, 64, 200, (1, 1))
    boiw = boiw._replace(embedding=jnp.zeros_like(boiw.embedding))
    state = TrainState.create({"params": params, "batch_stats": stats}, tx,
                              key, boiw=boiw)
    for step in range(2):       # a trace, an EMA and a count of 2
        grads = jax.tree.map(lambda p: (p * (0.1 + step)).astype(p.dtype),
                             state.params)
        state = apply_updates(state, tx, grads, stats)
    return state


def pattern_variables(config: str, seed: int, noise=()) -> dict:
    """Flax variables of ``config``'s model at the shapes its ``init``
    gives (``jax.eval_shape``: no compile), each leaf a zero-mean pattern
    of PERIOD values drawn from ``RandomState(seed)`` and tiled in C
    order: kernels at KERNEL_GAIN[config] / fan-in of unit variance (a
    pattern's sums grow with the fan-in, not its root: these gains keep
    YOLOX-s's and ResNet-50's outputs of order 1 and input-dependent, and
    a float32 forward within 1e-5 of a float64 one), norm scales near
    1, biases and means near 0, variances in [0.5, 1.5].  The kernels
    named in ``noise`` (paths under ``params``) are normal draws at
    1/sqrt(fan-in) instead."""
    model = build_model(get_config(config))
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                           train=False))
    rs = np.random.RandomState(seed)

    def tile(shape, values):
        return np.resize(np.float32(values),
                         int(np.prod(shape, dtype=np.int64))).reshape(shape)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        p = rs.randn(PERIOD)
        p = (p - p.mean()) / (p - p.mean()).std()
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            if "/".join(k.key for k in path[1:]) in noise:
                return np.float32(rs.randn(*shape) / np.sqrt(fan_in))
            return tile(shape, KERNEL_GAIN[config] * p / fan_in)
        if name == "var":
            return tile(shape, 0.5 + rs.rand(PERIOD))
        if name == "scale":
            return tile(shape, 1 + 0.1 * p)
        return tile(shape, 0.1 * p)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_ckpt_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_tool", os.path.join(ROOT, "tools", "ckpt_tool.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_archive(path: str) -> None:
    """The JAX two-stage archive of the stripped ``coarse_det`` and
    ``mp_det_res50`` (thresholds at ARCHIVE_THR, so that stage 2 fires on
    these weights)."""
    strip = _jax_ckpt_tool().cmd_strip
    cfg = get_config("mp_det_res50").model
    boiw = jax.device_get(init_boiw(
        jax.random.PRNGKey(1), cfg.num_classes, cfg.num_words,
        cfg.feat_channels, cfg.proxies_list))._asdict()
    boiw["embedding"] = np.zeros_like(boiw["embedding"])
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for name, seed, extra in (("coarse_det", 1, {}),
                                  ("mp_det_res50", 3, {"boiw": boiw})):
            v = pattern_variables(name, seed, NOISE if seed == 1 else ())
            dirs[name] = os.path.join(tmp, name)
            strip(argparse.Namespace(src=name, dst=dirs[name],
                                     keep_ema=False),
                  {"params": v["params"], "batch_stats": v["batch_stats"],
                   **extra})
        if os.path.exists(path):
            os.remove(path)
        jserve.archive_model(
            "coarse_det", dirs["coarse_det"], path, score_thr=ARCHIVE_THR,
            options={"eval.coarse_score_thr": ARCHIVE_THR},
            mp_config="mp_det_res50", mp_checkpoint_dir=dirs["mp_det_res50"])


def archive_digests(path: str) -> dict:
    """{"coarse" | "mp": [tree digest, sha256 of the leaves' digests]} of
    the archive's trees as ``restore_raw`` reads them."""
    import hashlib

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        _, dirs = jserve.load_archive(path, tmp)
        for stage, d in sorted(dirs.items()):
            tree, leaves = digests(restore_raw(d))
            lines = "\n".join(f"{k} {v}" for k, v in sorted(leaves.items()))
            out[stage] = [tree, hashlib.sha256(lines.encode()).hexdigest()]
    return out


def digests(tree):
    """(sha256 of the key/dtype/shape list, {path: sha256 of the bytes})
    of a restored tree, as ``chip_smoke.py: orbax_digests`` computes them
    (bfloat16 leaves by their 16-bit patterns)."""
    import hashlib

    lines, leaves = [], {}

    def walk(node, path):
        if isinstance(node, dict):
            lines.append(f"{path} dict")
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, list):
            lines.append(f"{path} list")
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif node is None:
            lines.append(f"{path} None")
        else:
            a = np.asarray(node)
            data = (a.view(np.uint16) if a.dtype.name == "bfloat16"
                    else a)
            lines.append(f"{path} {a.dtype.name} {tuple(a.shape)}")
            leaves[path] = hashlib.sha256(
                np.ascontiguousarray(data).tobytes()).hexdigest()

    walk(tree, "")
    return (hashlib.sha256("\n".join(lines).encode()).hexdigest(), leaves)


def write_trainstate() -> None:
    state = jax.device_get(fixture_state())
    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(tmp, state, epoch=2)
        if os.path.exists(OUT):
            shutil.rmtree(OUT)
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        shutil.copytree(path, OUT)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(OUT) for f in fs)
    tree, leaves = digests(restore_raw(OUT))
    print(f"wrote {OUT}: {size} bytes")
    print(f'ORBAX_FIXTURE_TREE = "{tree}"')
    print("ORBAX_FIXTURE_LEAVES = {")
    for k, v in sorted(leaves.items()):
        print(f'    "{k}": "{v}",')
    print("}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("which", nargs="*", default=["trainstate",
                                                      "two_stage"],
                        choices=["trainstate", "two_stage"])
    which = parser.parse_args().which
    if "trainstate" in which:
        write_trainstate()
    if "two_stage" in which:
        write_archive(ARCHIVE)
        print(f"wrote {ARCHIVE}: {os.path.getsize(ARCHIVE)} bytes")
        print("ORBAX_ARCHIVE_DIGESTS = {")
        for stage, pair in archive_digests(ARCHIVE).items():
            print(f'    "{stage}": {pair},'.replace("'", '"'))
        print("}")


if __name__ == "__main__":
    main()
