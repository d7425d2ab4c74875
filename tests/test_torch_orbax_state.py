"""JAX training checkpoints into the port's training state, on the CPU.

A JAX ``TrainState`` of the small YOLOX that ``tests/test_checkpoint.py:
_make_state`` builds (YOLOX-nano, 3 classes, ``PRNGKey(0)``, a BoIW
dictionary; initialised under ``jit`` here, which is 30 s faster), its
momentum trace, EMA, count and step set as after two steps (seeded
draws), under the ``yolox_sgd`` and the ``mp_det_sgd`` recipes,
written by the JAX package's ``save_checkpoint`` (orbax).  The port's ``restore_checkpoint`` of that directory (read by
``utils/orbax_read.py``, no JAX) must give the tensors that
``train_state_from_flax`` gives for the JAX package's own
``restore_checkpoint`` of it: parameters and BN statistics, the EMA, the
momentum trace, the count, the step and the BoIW dictionary, exactly (no
tolerance: both sides convert the same bytes).  Then ``train()`` resumes
from a JAX ``coarse_det`` checkpoint (``train.resume``) at its step, and
``train.load_from`` loads its weights shape-matched.
"""

import jax
import numpy as np
import pytest
import torch

import glsdet_tpu.train.loop as jloop
import glsdet_tpu_torch.train.loop as tloop
from glsdet_tpu.config import apply_overrides as j_overrides
from glsdet_tpu.config import get_config as j_get_config
from glsdet_tpu.models import YOLOXDetector as JYOLOX
from glsdet_tpu.train import TrainState as JTrainState
from glsdet_tpu.train import init_boiw as j_init_boiw
from glsdet_tpu.train import mp_det_sgd as j_mp_det_sgd
from glsdet_tpu.train import yolox_sgd as j_yolox_sgd
from glsdet_tpu.train import yolox_warm_cos as j_yolox_warm_cos
from glsdet_tpu_torch.models import YOLOXDetector
from glsdet_tpu_torch.train import schedules
from glsdet_tpu_torch.train.boiw import BoIWState
from glsdet_tpu_torch.train.state import TrainState, state_dict
from glsdet_tpu_torch.utils.flax_import import (state_dict_from_flax,
                                                train_state_from_flax)
from test_torch_train_loop import cfg_for
from torch_port_util import flax_vars, write_png_dataset


def _stepped(state, seed):
    """The state as after two steps: a seeded momentum trace, an EMA
    apart from the parameters, a count and a step of 2."""
    rs = np.random.RandomState(seed)

    def draw(a):
        a = np.asarray(a)
        if a.dtype.kind == "f":
            return np.asarray(rs.randn(*a.shape), a.dtype)
        return np.full(a.shape, 2, a.dtype)

    return jax.device_get(state.replace(
        step=np.int32(2), opt_state=jax.tree.map(draw, state.opt_state),
        ema_params=jax.tree.map(draw, state.ema_params)))


@pytest.fixture(scope="module")
def yolox_vars():
    return flax_vars(JYOLOX(num_classes=3, phi="nano"),
                     np.zeros((1, 64, 64, 3), np.float32), perturb=False)


def jax_state(recipe, variables):
    """``_make_state(with_boiw=True)``'s state under ``recipe``."""
    rng = jax.random.PRNGKey(0)
    tx = (j_yolox_sgd(j_yolox_warm_cos(0.01, 10, 100, 10))
          if recipe == "yolox_sgd" else j_mp_det_sgd(lambda count: 0.01))
    state = JTrainState.create(variables, tx, rng,
                               boiw=j_init_boiw(rng, 2, 8, 16, (1, 2)))
    return _stepped(state, seed=1)


def port_state(recipe):
    model = YOLOXDetector(3, "nano",
                          generator=torch.Generator().manual_seed(0))
    make = {"yolox_sgd": schedules.yolox_sgd,
            "mp_det_sgd": schedules.mp_det_sgd}[recipe]
    opt = make(model.parameters(), lambda count: 0.01)
    return model, opt


def tensors(state: TrainState) -> dict:
    sd = state_dict(state)
    named = {id(p): n for n, p in state.model.named_parameters()}
    out = {f"model/{k}": v for k, v in sd["model"].items()}
    out.update({f"ema/{k}": v for k, v in sd["ema_params"].items()})
    out.update({f"boiw/{k}": v for k, v in sd["boiw"].items()})
    for p, st in state.optimizer.state.items():
        out[f"momentum/{named[id(p)]}"] = st["momentum_buffer"]
    out["step"] = torch.tensor(sd["step"])
    out["count"] = torch.tensor(sd["optimizer"]["count"])
    return out


@pytest.mark.parametrize("recipe", ["yolox_sgd", "mp_det_sgd"])
def test_restore_checkpoint_equals_train_state_from_flax(tmp_path, recipe,
                                                        yolox_vars):
    jstate = jax_state(recipe, yolox_vars)
    path = jloop.save_checkpoint(str(tmp_path), jstate, epoch=1)

    model, opt = port_state(recipe)
    want = train_state_from_flax(jloop.restore_checkpoint(path, jstate),
                                 model, opt, torch.Generator().manual_seed(0))
    want = {k: v.clone() for k, v in tensors(want).items()}

    model, opt = port_state(recipe)
    b = jstate.boiw
    boiw = BoIWState(torch.zeros(b.embedding.shape),
                     torch.zeros(b.ptr.shape, dtype=torch.int64),
                     torch.zeros(b.proxies_prob.shape), torch.zeros(()))
    target = TrainState.create(model, opt, torch.Generator().manual_seed(0),
                               boiw=boiw)
    got = tensors(tloop.restore_checkpoint(path, target))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert int(got["step"]) == 2 and int(got["count"]) == 2
    n_trace = sum(k.startswith("momentum/") for k in got)
    assert n_trace == len(dict(model.named_parameters()))
    # the trace is not the parameters: the optimizer state did carry
    name = next(iter(dict(model.named_parameters())))
    assert not torch.equal(got[f"momentum/{name}"], got[f"model/{name}"])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_png_dataset(str(tmp_path_factory.mktemp("ds")))


def test_train_resumes_and_loads_from_a_jax_checkpoint(tmp_path, dataset,
                                                       yolox_vars):
    nc = {"model.num_classes": 3}      # yolox_vars' model
    over = {"train.epochs": 2, "train.num_last_epochs": 1, **nc}
    jcfg = j_overrides(j_get_config("coarse_det"), {
        "model.phi": "nano", "data.img_hw": (64, 64), **nc})
    tx = jloop.build_optimizer(jcfg, 2)
    jstate = jloop.make_state_template(jcfg, yolox_vars, tx,
                                       jax.random.PRNGKey(0))
    jstate = _stepped(jstate, seed=2)
    path = jloop.save_checkpoint(str(tmp_path / "jax"), jstate, epoch=1)

    # resume: the run starts at the checkpoint's step 2, epoch 2
    cfg = cfg_for("coarse_det", tmp_path / "a", dataset, **over,
                  **{"train.resume": path})
    seen = []
    state = tloop.train(cfg, eval_fn=lambda s, e: seen.append((e, s.step)),
                        device="cpu")
    assert seen == [(2, 4)] and state.step == 4

    # load_from: the weights, shape-matched, before the first step
    want = state_dict_from_flax({"params": jstate.params,
                                 "batch_stats": jstate.batch_stats})
    first = {}

    def probe(state, epoch):
        first.setdefault(epoch, state.step)

    cfg = cfg_for("coarse_det", tmp_path / "b", dataset,
                  **{"train.epochs": 1, "train.load_from": path, **nc})
    model = tloop.build_model(cfg, "cpu",
                              generator=torch.Generator().manual_seed(7))
    opt = tloop.build_optimizer(cfg, 2, model)
    fresh = tloop.make_state_template(cfg, model, opt,
                                      torch.Generator().manual_seed(7))
    loaded, n_loaded, skipped = tloop.load_weights(path, fresh)
    assert not skipped and n_loaded == len(want) + len(fresh.ema_params)
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    state = tloop.train(cfg, eval_fn=probe, device="cpu")
    assert first == {1: 2} and state.step == 2
