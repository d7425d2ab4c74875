"""Port parity: the FFA 4-level model (``yolox_ffa``:
``models/variants/ffa_model.py: FFAYoloBody``) against the JAX package's,
on the CPU, and its entries: ``build_model``, one train step, ``run_eval``
and the ``Detector`` facade's refusal.

- Eval forward: FFAYoloBody at phi nano (depthwise) and tiny at 64x64,
  flax weights with jittered constant leaves, the four levels' (cls, reg,
  obj) maps at rtol = atol = 1e-4 (``check_detector``).
- One ``make_yolox_train_step(strides=(4, 8, 16, 32))`` step in float64
  (both models in float64, the losses in float32 as both packages cast
  them), from the same weights, on the same normalised images (PR 8's
  method: tests/test_torch_yolox_train.py): each metric within 1e-5
  relative, ``num_fg`` equal, and every parameter's gradient within 1e-5
  of its leaf's max |value|.  The JAX step runs with ``optax.scale(1)``,
  so its update is its gradient; the port's step runs the yolox_ffa
  recipe (``build_optimizer``: adam_step) and its gradients are read
  before the update.
- ``run_eval(family="ffa")`` against the JAX runner over the PNG frames
  of tests/test_torch_eval_runner.py, the JAX model's own jittered
  detections as ground truth: detections paired one for one (IoU > 0.99,
  scores within 1e-4) and the 12 COCO stats within 1e-3.
- ``apis.Detector`` on family ffa: the JAX facade decodes every family
  but yolox as (cls, reg) and fails on FFA's three outputs; the port
  raises ``ValueError`` saying so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import glsdet_tpu.apis as japis
from glsdet_tpu.config import apply_overrides as japply
from glsdet_tpu.config import get_config as jget_config
from glsdet_tpu.data.coco import CocoDataset as JDataset
from glsdet_tpu.eval import runner as jrunner
from glsdet_tpu.models.variants import FFAYoloBody as JFFA
from glsdet_tpu.train.loop import build_model as jbuild_model
from glsdet_tpu.train.state import TrainState as JState
from glsdet_tpu.train.steps import make_yolox_train_step as j_make_step
from glsdet_tpu_torch import apis
from glsdet_tpu_torch.config import apply_overrides, get_config
from glsdet_tpu_torch.data.coco import CocoDataset as TDataset
from glsdet_tpu_torch.eval import runner as trunner
from glsdet_tpu_torch.models.build import build_model
from glsdet_tpu_torch.models.variants import FFA_STRIDES, FFAYoloBody
from glsdet_tpu_torch.train.loop import (build_optimizer, family_strides,
                                         make_state_template)
from glsdet_tpu_torch.train.steps import make_yolox_train_step
from glsdet_tpu_torch.utils.flax_import import (params_from_flax,
                                                state_dict_from_flax)
from test_torch_eval_runner import (FRAMES, Recorder, _gts_from, _match,
                                    _run, _write_set)
from test_torch_yolox_train import make_batch, torch_batch
from torch_port_util import (assert_leaf_close, check_detector, flax_vars,
                             load_flax, normalized, rand_nhwc)

NC = 10
SMALL = {"model.phi": "nano", "data.img_hw": (64, 96),
         "model.dtype": "float32"}


@pytest.mark.parametrize("phi", ["nano", "tiny"])
def test_ffa_body_matches_flax(phi):
    check_detector(JFFA(num_classes=NC, phi=phi),
                   FFAYoloBody(NC, phi,
                               generator=torch.Generator().manual_seed(0)),
                   rand_nhwc((2, 64, 64, 3), seed=1))


def test_build_model_builds_yolox_ffa():
    cfg = apply_overrides(get_config("yolox_ffa"), SMALL)
    model = build_model(cfg, device="cpu")
    assert type(model) is FFAYoloBody and not model.training
    assert family_strides("ffa") == FFA_STRIDES == (4, 8, 16, 32)
    with torch.inference_mode():
        cls, reg, obj = model(torch.zeros(1, 3, 64, 96))
    assert [tuple(c.shape[1:3]) for c in cls] == [(16, 24), (8, 12),
                                                  (4, 6), (2, 3)]
    assert all(o.shape[-1] == 1 for o in obj) and reg[0].shape[-1] == 4


def test_train_step_float64_matches_jax():
    hw = SMALL["data.img_hw"]
    jm = JFFA(num_classes=NC, phi="nano", dtype=jnp.float64)
    variables = flax_vars(JFFA(num_classes=NC, phi="nano"),
                          np.zeros((2, *hw, 3), np.float32))
    batch = normalized(make_batch(np.random.RandomState(4)))
    with jax.enable_x64(True):
        tx = optax.scale(1.0)               # the update is the gradient
        jstate = JState.create(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables),
            tx, jax.random.PRNGKey(3))
        step = jax.jit(j_make_step(jm, tx, img_hw=hw, strides=FFA_STRIDES,
                                   normalize=False))
        jnew, jmetrics = step(jstate, {k: jnp.asarray(v.copy())
                                       for k, v in batch.items()})
        jgrads = jax.device_get(jax.tree.map(
            lambda a, b: a - b, jnew.params, jstate.params))
        jmetrics = {k: float(v) for k, v in jmetrics.items()}

    cfg = apply_overrides(get_config("yolox_ffa"), SMALL)
    model = load_flax(build_model(cfg, device="cpu"), variables).double()
    opt = build_optimizer(cfg, 100, model)
    state = make_state_template(cfg, model, opt,
                                torch.Generator().manual_seed(0))
    grads = {}
    named = dict(model.named_parameters())
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.clone() for n, p in named.items()}))
    pstep = make_yolox_train_step(model, hw, strides=family_strides("ffa"),
                                  normalize=False)
    state, metrics = pstep(state, torch_batch(batch))
    assert set(metrics) == set(jmetrics)
    assert int(metrics["num_fg"]) == int(jmetrics["num_fg"]) > 0
    for k, w in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), w, rtol=1e-5, atol=0,
                                   err_msg=k)
    want = params_from_flax(jgrads)
    assert set(want) == set(grads)
    for name, w in want.items():
        assert_leaf_close(grads[name], w.double(), f"grad {name}", 1e-5)


@pytest.fixture(scope="module")
def ffa_set(tmp_path_factory):
    """The JAX FFA at 64x64 (jitted apply, flax variables), the port's on
    the same weights, and the PNG frames with the JAX model's own
    jittered detections as ground truth."""
    jm = JFFA(num_classes=NC, phi="nano")
    v = flax_vars(jm, np.zeros((1, 64, 64, 3), np.float32))
    japply = jax.jit(lambda vv, x: jm.apply(vv, x, train=False))
    tm = load_flax(FFAYoloBody(NC, "nano", generator=torch.Generator()), v)
    root = str(tmp_path_factory.mktemp("ffa_set"))
    ann, img_root = _write_set(root, name="bare.json")
    rec = Recorder(jrunner.CocoEvaluator)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunner, "CocoEvaluator", rec)
        jrunner.run_eval(JDataset(ann, img_root), japply, "ffa", (64, 64),
                         NC, variables=jax.device_put(v), **EVAL_KW)
    ann, img_root = _write_set(root, _gts_from(rec.calls[0][1], 0))
    return japply, jax.device_put(v), tm, ann, img_root


EVAL_KW = dict(batch_size=2, score_thr=1e-3, max_dets=100, verbose=False)


def test_run_eval_ffa_matches_jax(ffa_set, monkeypatch):
    japply, v, tm, ann, img_root = ffa_set
    want, wstats, wdets = _run(jrunner, monkeypatch, jrunner.run_eval,
                               JDataset(ann, img_root), japply, "ffa",
                               (64, 64), NC, variables=v, **EVAL_KW)
    got, gstats, gdets = _run(trunner, monkeypatch, trunner.run_eval,
                              TDataset(ann, img_root), tm, "ffa",
                              (64, 64), NC, device="cpu", **EVAL_KW)
    pairs, n_got, n_want = _match(gdets, wdets)
    assert pairs == n_got == n_want and n_want > 50
    assert gstats["images"] == wstats["images"] == len(FRAMES)
    np.testing.assert_allclose(got.stats, want.stats, atol=1e-3)
    assert want.ap > 0.05 and want.ap50 > 0.2


def test_detector_refuses_ffa_as_the_jax_facade_fails():
    opts = {"model.phi": "nano", "data.img_hw": (64, 64),
            "model.dtype": "float32"}
    jd = japis.Detector.__new__(japis.Detector)
    cfg = japply(jget_config("yolox_ffa"), dict(opts))
    model = jbuild_model(cfg)
    jd.cfg, jd.score_thr = cfg, cfg.eval.score_thr
    jd.class_names = list(apis.VISDRONE_CLASSES)
    jd._raw_apply = model.apply
    # the facade fails while tracing: zero weights of the right shapes
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    jd._variables = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                                 shapes)
    jd._set_fwd(model.apply)
    frame = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(ValueError):
        jd.detect(frame)
    with pytest.raises(ValueError, match="family 'ffa'"):
        apis.Detector("yolox_ffa", options=opts, device="cpu")

