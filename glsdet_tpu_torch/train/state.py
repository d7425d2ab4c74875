"""Train state: the model (parameters and BN running statistics), the
optimizer (momentum buffers and update count), an EMA of the parameters,
the generator and the BoIW dictionary; the counterpart of
``glsdet_tpu.train.state``.

The JAX package's state is an immutable pytree; here the model and the
optimizer are updated in place and :func:`apply_updates` returns the same
object with its other fields advanced.  ``step`` is a host integer, so
the schedules and the EMA momentum are read without waiting for the
card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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
