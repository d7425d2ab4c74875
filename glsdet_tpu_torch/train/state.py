"""Train state: the model (parameters and BN running statistics), the
optimizer (momentum buffers and update count), an EMA of the parameters,
the generator and the BoIW dictionary; the counterpart of
``glsdet_tpu.train.state``.  :func:`state_dict` and
:func:`load_state_dict` carry all of it to and from a checkpoint
(``train/loop.py``).

The JAX package's state is an immutable pytree; here the model and the
optimizer are updated in place and :func:`apply_updates` returns the same
object with its other fields advanced.  ``step`` is a host integer, so
the schedules and the EMA momentum are read without waiting for the
card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from glsdet_tpu_torch.train.boiw import BoIWState
from glsdet_tpu_torch.train.schedules import ema_momentum


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Dict[str, torch.Tensor]  # parameters only, no BN stats
    generator: torch.Generator
    boiw: Optional[BoIWState] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               generator: torch.Generator,
               boiw: Optional[BoIWState] = None) -> "TrainState":
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        return cls(step=0, model=model, optimizer=optimizer,
                   ema_params=ema, generator=generator, boiw=boiw)


@torch.no_grad()
def apply_updates(state: TrainState,
                  new_boiw: Optional[BoIWState] = None) -> TrainState:
    """Step the optimizer on the gradients in ``.grad``, then move the
    EMA towards the new parameters with ``ema_momentum(step)``:
    ``e <- e (1 - m) + p m``."""
    state.optimizer.step()
    m = ema_momentum(state.step)
    names = list(state.ema_params)
    params = dict(state.model.named_parameters())
    ema = [state.ema_params[n] for n in names]
    torch._foreach_mul_(ema, float(np.float32(1) - np.float32(m)))
    torch._foreach_add_(ema, [params[n].detach() for n in names], alpha=m)
    state.step += 1
    if new_boiw is not None:
        state.boiw = new_boiw
    return state


def state_dict(state: TrainState) -> Dict[str, Any]:
    """Everything that resuming needs, as tensors copied to the CPU (a
    snapshot: training may go on while it is written): ``step``,
    ``model`` (parameters and BN statistics), ``optimizer`` (its
    ``state_dict`` and update ``count``), ``ema_params``, ``generator``
    (its state) and ``boiw`` (None for families without one)."""
    def snap(t):
        return t.detach().to("cpu", copy=True)

    opt = state.optimizer.state_dict()
    opt_state = {k: {n: snap(v) if torch.is_tensor(v) else v
                     for n, v in st.items()}
                 for k, st in opt["state"].items()}
    return {
        "step": int(state.step),
        "model": {k: snap(v) for k, v in state.model.state_dict().items()},
        "optimizer": {"state": opt_state,
                      "param_groups": opt["param_groups"],
                      "count": int(getattr(state.optimizer, "count", 0))},
        "ema_params": {k: snap(v) for k, v in state.ema_params.items()},
        "generator": state.generator.get_state(),
        "boiw": (None if state.boiw is None
                 else {k: snap(v) for k, v in state.boiw._asdict().items()}),
    }


def _load_adam(state: TrainState, adam: Dict[str, Any]) -> None:
    """Adam's moments by parameter name into the optimizer's state of
    each parameter it trains (copies: Adam updates them in place)."""
    named = dict(state.model.named_parameters())
    trained = {id(p) for g in state.optimizer.param_groups
               for p in g["params"]}
    for name, mu in adam["exp_avg"].items():
        p = named[name]
        if id(p) in trained:
            state.optimizer.state[p] = {
                "step": torch.tensor(float(adam["step"]),
                                     dtype=torch.float32),
                "exp_avg": mu.to(p, copy=True),
                "exp_avg_sq": adam["exp_avg_sq"][name].to(p, copy=True)}


@torch.no_grad()
def load_state_dict(state: TrainState, sd: Dict[str, Any]) -> TrainState:
    """Restore :func:`state_dict` into ``state`` in place (each tensor
    onto the device and dtype of the one it replaces) and return it.

    A JAX ``TrainState`` in the port's form (``utils/flax_import.py:
    checkpoint_from_flax``) loads too: its optimizer is the SGD momentum
    trace by parameter name (each parameter's ``momentum_buffer``) or
    Adam's moments by parameter name (each trained parameter's
    ``exp_avg``, ``exp_avg_sq`` and ``step`` in a ``torch.optim.Adam``),
    and the schedule count; its ``generator`` is None (``state``'s
    generator stays)."""
    for key in ("step", "model", "optimizer", "ema_params", "boiw"):
        if key not in sd:
            raise ValueError(f"the checkpoint has no {key!r}: not a "
                             "training checkpoint (a weights-only artifact "
                             "loads through train/loop.py: load_weights)")
    opt = sd["optimizer"]
    if opt is None:
        raise ValueError("the checkpoint holds no optimizer state (neither "
                         "an SGD momentum trace nor Adam's moments)")
    state.step = int(sd["step"])
    state.model.load_state_dict(sd["model"], strict=True)
    if "adam" in opt:
        if not isinstance(state.optimizer, torch.optim.Adam):
            raise ValueError("the checkpoint holds Adam's moments; the "
                             "optimizer is not Adam")
        _load_adam(state, opt["adam"])
        state.optimizer.count = int(opt["count"])
    elif "momentum" in opt:
        named = dict(state.model.named_parameters())
        for name, buf in opt["momentum"].items():
            # a copy: the optimizer updates its buffers in place
            state.optimizer.state[named[name]]["momentum_buffer"] = \
                buf.to(named[name], copy=True)
        state.optimizer.count = int(opt["count"])
    else:
        state.optimizer.load_state_dict({"state": opt["state"],
                                         "param_groups": opt["param_groups"]})
        if hasattr(state.optimizer, "count"):
            state.optimizer.count = int(opt["count"])
    for k, v in sd["ema_params"].items():
        state.ema_params[k].copy_(v)
    if sd["generator"] is not None:
        state.generator.set_state(sd["generator"])
    if (sd["boiw"] is None) != (state.boiw is None):
        raise ValueError("checkpoint and state disagree on the BoIW "
                         "dictionary")
    if state.boiw is not None:
        state.boiw = BoIWState(**{
            k: v.to(getattr(state.boiw, k).device)
            for k, v in sd["boiw"].items()})
    return state
