"""Training in groups of ``train.steps_per_call`` steps, and Adam's
moments carried from a JAX checkpoint, on the CPU.

Groups: the port's ``train()`` of YOLOX-nano at 64x64 (8 PNG frames,
batch 4: 2 steps an epoch) for 5 steps with ``steps_per_call=2`` (a
group in each of the first two epochs, then a single step at the
``max_steps`` cut: the loop's debug record names the two groups) ends
in the state of 5 single steps, within 1e-6 of each leaf's max (the same
operations on the same batches).  The JAX
loop's grouping is held event for event in
``tests/test_torch_train_loop.py`` (the stubbed loops).

Adam: the JAX package's ``adam_step`` recipe (its ``build_optimizer``:
``optax.chain(add_decayed_weights, adam(epoch_step_decay))``, and the
same wrapped by ``freeze_sections``, whose frozen parameters hold
optax's ``MaskedNode`` in place of moments) on a two-Dense model, two
JAX steps; the port's ``ScheduledAdam`` over the same-named model takes
that state through ``train_state_from_flax`` and through the JAX
package's orbax checkpoint (``train/loop.py: restore_checkpoint``, what
``train.resume`` runs), both equal; its third step matches the JAX
third step: parameters, EMA and both moments within 1e-5 of each
leaf's max (float32, XLA and torch sum the gradients' products in other
orders), step and counts equal.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import glsdet_tpu.train.loop as jloop
import glsdet_tpu_torch.train.loop as tloop
from glsdet_tpu.config import apply_overrides as j_overrides
from glsdet_tpu.config import get_config as j_get_config
from glsdet_tpu.train.state import TrainState as JState
from glsdet_tpu.train.state import apply_updates as j_apply
from glsdet_tpu_torch.config import apply_overrides, get_config
from glsdet_tpu_torch.train.state import apply_updates, state_dict
from glsdet_tpu_torch.utils.flax_import import (params_from_flax,
                                                train_state_from_flax)
from test_torch_train_loop import TinyJax, TinyTorch, cfg_for
from torch_port_util import write_png_dataset


def assert_close(got, want, what, tol):
    """Nested dicts of tensors: each within ``tol`` of its max |want|."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_close(got[k], want[k], f"{what}/{k}", tol)
    elif torch.is_tensor(want):
        scale = max(float(want.abs().max()), 1e-12) if want.numel() else 1
        if want.is_floating_point():
            assert float((got - want).abs().max()) <= tol * scale, what
        else:
            assert torch.equal(got, want), what
    else:
        assert got == want, what


def test_groups_of_steps_train_as_single_steps(tmp_path, caplog):
    dataset = write_png_dataset(str(tmp_path / "ds"))
    states = {}
    for spc in (1, 2):
        cfg = cfg_for("coarse_det", tmp_path / f"k{spc}", dataset, **{
            "train.epochs": 3, "train.steps_per_call": spc,
            "train.log_interval": 2})
        caplog.clear()
        with caplog.at_level(logging.DEBUG, logger="glsdet_tpu_torch"):
            state = tloop.train(cfg, max_steps=5, device="cpu")
        assert state.step == 5
        groups = [r.getMessage() for r in caplog.records
                  if "group of" in r.getMessage()]
        assert groups == ([] if spc == 1 else [
            "step 0: group of 2 steps", "step 2: group of 2 steps"])
        sd = state_dict(state)
        sd["generator"] = sd["generator"].clone()
        states[spc] = sd
    assert_close(states[2], states[1], "state", 1e-6)


class Data:
    """Inputs and targets of the toy regression the steps fit."""

    def __init__(self, seed):
        rs = np.random.RandomState(seed)
        self.x = rs.rand(4, 6, 6, 3).astype(np.float32)
        self.y = rs.randn(4, 2).astype(np.float32)


def jax_grads(params, d):
    def loss(p):
        out = TinyJax().apply({"params": p}, jnp.asarray(d.x))
        return jnp.sum((out - jnp.asarray(d.y)) ** 2)

    return jax.grad(loss)(params)


def port_step(state, d):
    x = torch.from_numpy(d.x).mean(dim=(1, 2))
    out = state.model.head(state.model.backbone(x))
    loss = ((out - torch.from_numpy(d.y)) ** 2).sum()
    state.optimizer.zero_grad()
    loss.backward()
    return apply_updates(state)


@pytest.mark.parametrize("frozen", [(), ("backbone",)])
def test_adam_state_from_a_jax_checkpoint_resumes(tmp_path, frozen):
    over = {"train.epochs": 2, "train.base_lr": 0.01,
            "train.weight_decay": 5e-4}
    jcfg = j_overrides(j_get_config("yolox_ffa"), over)
    tcfg = apply_overrides(get_config("yolox_ffa"), over)
    assert jcfg.train.optimizer == tcfg.train.optimizer == "adam_step"
    spe = 2                     # the third step is in the second epoch
    tx = jloop.build_optimizer(jcfg, spe, frozen_sections=frozen)
    variables = jax.jit(TinyJax().init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 6, 6, 3)))
    jstate = JState.create(variables, tx, jax.random.PRNGKey(1))
    data = [Data(seed) for seed in range(3)]
    step = jax.jit(lambda s, g: j_apply(s, tx, g, s.batch_stats))
    for d in data[:2]:
        jstate = step(jstate, jax_grads(jstate.params, d))
    path = jloop.save_checkpoint(str(tmp_path), jstate, 2)

    def port_state():
        model = TinyTorch()
        opt = tloop.build_optimizer(tcfg, spe, model,
                                    frozen_sections=frozen)
        return model, opt

    model, opt = port_state()
    state = train_state_from_flax(jax.device_get(jstate), model, opt,
                                  torch.Generator())
    model2, opt2 = port_state()
    resumed = tloop.restore_checkpoint(path, tloop.make_state_template(
        tcfg, model2, opt2, torch.Generator()))
    a, b = state_dict(state), state_dict(resumed)
    assert_close(b["optimizer"], a["optimizer"], "optimizer", 0.0)
    assert_close(b["model"], a["model"], "model", 0.0)
    n_trained = sum(p.requires_grad for p in model.parameters())
    assert len(state.optimizer.state) == n_trained == (2 if frozen else 4)
    assert state.step == 2 and state.optimizer.count == 2

    jstate = step(jstate, jax_grads(jstate.params, data[2]))
    for s in (state, resumed):
        port_step(s, data[2])
        assert s.step == 3 and s.optimizer.count == 3
        named = dict(s.model.named_parameters())
        want = params_from_flax(jax.device_get(jstate.params))
        assert_close({k: named[k].detach() for k in want}, want, "params",
                     1e-5)
        assert_close({k: s.ema_params[k] for k in want},
                     params_from_flax(jax.device_get(jstate.ema_params)),
                     "ema", 1e-5)
        adam = _adam(jax.device_get(jstate.opt_state))
        for field, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            mom = params_from_flax(getattr(adam, field))
            assert mom and len(mom) == n_trained
            got = {k: s.optimizer.state[named[k]][moment] for k in mom}
            assert_close(got, mom, moment, 1e-5)
            for k in mom:
                assert float(s.optimizer.state[named[k]]["step"]) == 3.0
        assert int(adam.count) == 3


def _adam(opt_state):
    """optax's ScaleByAdamState in a (possibly multi_transform) state."""
    found = []

    def walk(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for n in node:
                walk(n)
        elif isinstance(node, dict):
            for n in node.values():
                walk(n)
        elif hasattr(node, "inner_states"):
            walk(node.inner_states)
        elif hasattr(node, "inner_state"):
            walk(node.inner_state)

    walk(opt_state)
    (adam,) = found
    return adam
