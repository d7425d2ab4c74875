"""JAX checkpoints at full width into the port's entry points, on the CPU.

- ``coarse_det`` (YOLOX-s, 10 classes): a ``TrainState`` written by the
  JAX package's ``save_checkpoint``; ``mp_det_res50`` (MP-Det ResNet-50):
  the weights-only artifact of the JAX ``tools/ckpt_tool.py strip``
  (``--no-keep-ema``).  Their weights are seeded draws of the shapes
  ``init`` gives (``jax.eval_shape``: no compile), the BN statistics and
  norm parameters off their constants, the EMA apart from the
  parameters.  ``read_orbax`` equals ``restore_raw`` leaf for leaf on both,
  and the port's ``apis.init_detector(name, checkpoint=dir,
  device="cpu")`` forward equals the JAX ``init_detector``'s on the same
  ``RandomState(0)`` frame, both in float32 (``model.dtype``), per
  output map to rtol = atol = 1e-4 (tests/test_torch_models.py and
  test_torch_mpdet.py's tolerance), at 64x64 and 128x128 as those tests
  run them.

The archives are in tests/test_torch_orbax_serve.py.
"""

import argparse
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import glsdet_tpu.apis as japis
import glsdet_tpu.train.loop as jloop
from glsdet_tpu.config import get_config as j_get_config
from glsdet_tpu.data.coco import normalize as j_normalize
from glsdet_tpu_torch import apis
from glsdet_tpu_torch.utils.orbax_read import read_orbax
from test_torch_orbax import assert_same_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = {"model.dtype": "float32"}


def seeded_variables(cfg, seed: int) -> dict:
    """Flax variables of ``cfg``'s model drawn from ``RandomState(seed)``
    at the shapes its ``init`` gives: kernels at 1/sqrt(fan-in), norm
    scales near 1, biases and means near 0, variances in [0.5, 1.5]."""
    model = jloop.build_model(cfg)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 64, 64, 3)), train=False))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return np.float32(rs.randn(*shape) / np.sqrt(fan_in))
        if name == "var":
            return np.float32(0.5 + rs.rand(*shape))
        if name == "scale":
            return np.float32(1.0 + 0.1 * rs.randn(*shape))
        return np.float32(0.1 * rs.randn(*shape))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def frame_input(hw) -> np.ndarray:
    img = np.random.RandomState(0).randint(0, 256, (*hw, 3), np.uint8)
    return j_normalize(img)[None].astype(np.float32)


def assert_forward_equal(name, path, hw):
    """The JAX ``init_detector`` forward against the port's."""
    _, jmodel, jv = japis.init_detector(name, checkpoint=path, options=F32)
    x = frame_input(hw)
    want = jax.jit(lambda v, im: jmodel.apply(v, im, train=False))(jv, x)
    _, model, _ = apis.init_detector(name, checkpoint=path, options=F32,
                                     device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    flat = jax.tree_util.tree_leaves(want)
    gflat = [t for maps in got for t in maps]
    assert len(flat) == len(gflat) > 0
    for g, w in zip(gflat, flat):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_coarse_det_train_state_at_full_width(tmp_path):
    cfg = j_get_config("coarse_det")
    v = seeded_variables(cfg, seed=1)
    tx = jloop.build_optimizer(cfg, 1000)
    state = jloop.make_state_template(cfg, v, tx, jax.random.PRNGKey(0))
    rs = np.random.RandomState(2)
    state = state.replace(step=jnp.int32(7), ema_params=jax.tree.map(
        lambda p: np.float32(p + 0.01 * rs.randn(*p.shape)), v["params"]))
    path = jloop.save_checkpoint(str(tmp_path), state, epoch=7)
    assert_same_tree(read_orbax(path), jloop.restore_raw(path))
    assert_forward_equal("coarse_det", path, (64, 64))


def _jax_ckpt_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_tool", os.path.join(ROOT, "tools", "ckpt_tool.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mp_det_res50_stripped_artifact_at_full_width(tmp_path):
    cfg = j_get_config("mp_det_res50")
    v = seeded_variables(cfg, seed=3)
    boiw = jloop.init_boiw(jax.random.PRNGKey(1), cfg.model.num_classes,
                           cfg.model.num_words, cfg.model.feat_channels,
                           cfg.model.proxies_list)
    raw = {"params": v["params"], "batch_stats": v["batch_stats"],
           "boiw": jax.device_get(boiw)._asdict(), "step": np.int32(3),
           "opt_state": None}
    dst = str(tmp_path / "stripped")
    _jax_ckpt_tool().cmd_strip(
        argparse.Namespace(src="state", dst=dst, keep_ema=False), raw)
    assert sorted(jloop.restore_raw(dst)) == ["batch_stats", "boiw",
                                              "params"]
    assert_same_tree(read_orbax(dst), jloop.restore_raw(dst))
    assert_forward_equal("mp_det_res50", dst, (128, 128))
