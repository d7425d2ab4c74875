"""Flax variables of the JAX package -> ``state_dict`` of the port.

The port's submodules carry the flax scope names, so the bridge is a path
walk: ``{"params": {"backbone": {"stem": {"conv": {"conv": {"kernel":
...}}}}}}`` becomes ``backbone.stem.conv.conv.weight``.  Leaf renames:

- conv ``kernel`` (HWIO) -> ``weight`` (OIHW), depthwise included;
- ``Dense`` ``kernel`` (in, out) -> ``weight`` (out, in); the
  ``DenseGeneral`` kernels of flax's ``MultiHeadDotProductAttention``
  flatten their head axes first: ``query``/``key``/``value`` (D, heads,
  head_dim) and ``out`` (heads, head_dim, D), their (heads, head_dim)
  biases to one axis;
- norm (BatchNorm, GroupNorm, LayerNorm) ``scale``/``bias`` ->
  ``weight``/``bias``: a 1-D ``scale`` is always a norm's;
- BN batch stats ``mean``/``var`` -> ``running_mean``/``running_var``,
  plus the ``num_batches_tracked`` counter torch keeps;
- the 0-D ``Scale.scale``, ``MPHead.proxies`` and the variants' own
  parameters (``codebook``, ``smooth``, ``ls1``, ``ls2``) keep their
  names.

:func:`train_state_from_flax` carries a whole JAX ``TrainState`` across
(the MP-Det and GFL recipes' ``mp_det_sgd``, the YOLOX recipe's
``yolox_sgd`` with its masked weight decay and Nesterov trace):
parameters and BN statistics, the EMA, the SGD momentum trace of optax's
``opt_state`` (into the torch optimizer's ``momentum_buffer`` s, whichever
parameter group holds each), the schedule count, the step and, for
MP-Det, the BoIW dictionary.

Takes numpy arrays (``jax.device_get`` of the variables), so this module
imports neither jax nor flax.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from glsdet_tpu_torch.train.boiw import BoIWState
from glsdet_tpu_torch.train.state import TrainState

_KEPT = ("bias", "scale", "proxies", "codebook", "smooth", "ls1", "ls2")


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Map flax ``{"params": ..., "batch_stats": ...}`` to a state_dict
    that ``load_state_dict(strict=True)`` accepts."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _walk(variables.get("params", {})):
        *mods, leaf = path
        parent = mods[-1] if mods else ""
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)        # HWIO -> OIHW
            elif arr.ndim == 3 and parent == "out":    # (heads, hd, D)
                arr = arr.reshape(-1, arr.shape[-1]).T
            elif arr.ndim == 3:                        # (D, heads, hd)
                arr = arr.reshape(arr.shape[0], -1).T
            elif arr.ndim == 2:                        # Dense (in, out)
                arr = arr.T
            else:
                raise ValueError(f"{'/'.join(path)}: unexpected kernel "
                                 f"shape {arr.shape}")
            leaf = "weight"
        elif leaf == "scale" and arr.ndim == 1:
            leaf = "weight"
        elif leaf == "bias" and arr.ndim == 2:         # (heads, hd)
            arr = arr.reshape(-1)
        elif leaf not in _KEPT:
            raise ValueError(f"unmapped flax parameter {'/'.join(path)}")
        out[".".join(mods + [leaf])] = torch.from_numpy(
            np.array(arr, np.float32))
    for path, arr in _walk(variables.get("batch_stats", {})):
        *mods, leaf = path
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if name is None:
            raise ValueError(f"unmapped flax batch stat {'/'.join(path)}")
        out[".".join(mods + [name])] = torch.from_numpy(
            np.array(arr, np.float32))
        out[".".join(mods + ["num_batches_tracked"])] = torch.tensor(0)
    return out


def optax_fields(node, name: str) -> list:
    """Every value of field ``name`` in an optax state (nested tuples and
    NamedTuples), in order."""
    found = []
    if hasattr(node, "_fields"):
        for field in node._fields:
            value = getattr(node, field)
            if field == name:
                found.append(value)
            else:
                found += optax_fields(value, name)
    elif isinstance(node, (tuple, list)):
        for item in node:
            found += optax_fields(item, name)
    return found


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``params`` tree (or one shaped like it: the EMA, optax's
    momentum trace) as port parameter names -> tensors."""
    return state_dict_from_flax({"params": params})


def train_state_from_flax(state, model: nn.Module,
                          optimizer: torch.optim.Optimizer,
                          generator: torch.Generator) -> TrainState:
    """A port :class:`TrainState` over ``model`` / ``optimizer`` (the
    port's ``mp_det_sgd`` or ``yolox_sgd``) holding a JAX ``TrainState``
    of numpy leaves: the weights and BN statistics are loaded into
    ``model``; the momentum trace becomes each parameter's
    ``momentum_buffer`` and the schedule count ``optimizer.count``.  The
    JAX key is not carried: ``generator`` takes its place."""
    dev = next(model.parameters()).device
    model.load_state_dict(state_dict_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats}),
        strict=True)
    named = dict(model.named_parameters())
    (trace,) = optax_fields(state.opt_state, "trace")
    counts = optax_fields(state.opt_state, "count")
    for name, buf in params_from_flax(trace).items():
        optimizer.state[named[name]]["momentum_buffer"] = buf.to(named[name])
    optimizer.count = int(counts[-1]) if counts else 0
    ema = {n: t.to(named[n]) for n, t in params_from_flax(
        state.ema_params).items()}
    boiw = None
    if state.boiw is not None:
        b = state.boiw
        boiw = BoIWState(
            embedding=torch.from_numpy(np.array(b.embedding, np.float32)
                                       ).to(dev),
            ptr=torch.from_numpy(np.array(b.ptr, np.int64)).to(dev),
            proxies_prob=torch.from_numpy(np.array(b.proxies_prob,
                                                   np.float32)).to(dev),
            beta=torch.tensor(float(b.beta), device=dev))
    return TrainState(step=int(state.step), model=model, optimizer=optimizer,
                      ema_params=ema, generator=generator, boiw=boiw)
