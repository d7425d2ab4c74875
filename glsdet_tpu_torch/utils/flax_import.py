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

:func:`checkpoint_from_flax` turns a JAX ``TrainState`` (the object, or
the raw tree of dicts and lists that ``utils/orbax_read.py: read_orbax``
gives for an orbax checkpoint, stripped artifacts and bare parameter trees
included) into the port's checkpoint form (``train/state.py:
state_dict``), with the optimizer as the SGD momentum trace by parameter
name and the schedule count; :func:`train_state_from_flax` loads that into
a port :class:`TrainState` (the MP-Det and GFL recipes' ``mp_det_sgd``,
the YOLOX recipe's ``yolox_sgd`` with its masked weight decay and Nesterov
trace): parameters and BN statistics, the EMA, the momentum trace of
optax's ``opt_state`` (into the torch optimizer's ``momentum_buffer`` s,
whichever parameter group holds each), the schedule count, the step and,
for MP-Det, the BoIW dictionary.

Takes numpy arrays (``jax.device_get`` of the variables; bfloat16 leaves
as ``torch.bfloat16`` tensors, as ``read_orbax`` gives them), so this
module imports neither jax nor flax.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from glsdet_tpu_torch.train.boiw import BoIWState
from glsdet_tpu_torch.train.state import TrainState, load_state_dict

_KEPT = ("bias", "scale", "proxies", "codebook", "smooth", "ls1", "ls2")


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), _numpy(v)


def _numpy(v) -> np.ndarray:
    """A leaf as numpy (a bfloat16 tensor as float32, exact)."""
    return v.float().numpy() if torch.is_tensor(v) else np.asarray(v)


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
    NamedTuples, or the dicts and lists of its raw checkpoint tree), in
    order."""
    found = []
    if hasattr(node, "_fields"):
        node = {f: getattr(node, f) for f in node._fields}
    if isinstance(node, Mapping):
        for field, value in node.items():
            if field == name:
                found.append(value)
            else:
                found += optax_fields(value, name)
    elif isinstance(node, (tuple, list)):
        for item in node:
            found += optax_fields(item, name)
    return found


def _unmasked(tree):
    """A params-shaped optax tree without its masked leaves (optax's
    ``MaskedNode`` of the parameters another partition owns, as
    ``freeze_sections``' ``multi_transform`` leaves them, or what a
    checkpoint keeps of one: None, an empty node); None if nothing is
    left."""
    if hasattr(tree, "_fields"):
        tree = {f: getattr(tree, f) for f in tree._fields}
    if isinstance(tree, Mapping):
        kept = {k: v for k, v in ((k, _unmasked(v)) for k, v in tree.items())
                if v is not None}
        return kept or None
    return tree


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``params`` tree (or one shaped like it: the EMA, optax's
    momentum trace or Adam moments, their masked leaves left out) as port
    parameter names -> tensors."""
    return state_dict_from_flax({"params": _unmasked(params) or {}})


def _adam_state(opt_state):
    """optax's ``ScaleByAdamState`` in ``opt_state`` (the node with
    ``mu`` and ``nu``), or None."""
    if hasattr(opt_state, "_fields"):
        opt_state = {f: getattr(opt_state, f) for f in opt_state._fields}
    if isinstance(opt_state, Mapping):
        if "mu" in opt_state and "nu" in opt_state:
            return opt_state
        nodes = opt_state.values()
    elif isinstance(opt_state, (tuple, list)):
        nodes = opt_state
    else:
        return None
    for node in nodes:
        found = _adam_state(node)
        if found is not None:
            return found
    return None


def _field(state, name: str):
    if isinstance(state, Mapping):
        return state.get(name)
    return getattr(state, name, None)


def checkpoint_from_flax(state) -> Dict[str, Any]:
    """A JAX ``TrainState`` (or its raw tree, a stripped artifact of
    ``tools/ckpt_tool.py strip``, or a bare ``params`` tree) in the
    port's checkpoint form: ``step``, ``model`` (parameters and BN
    statistics), ``ema_params``, ``boiw``, and ``optimizer`` as
    ``{"momentum": {name: trace}, "count": n}`` for the SGD recipes or
    ``{"adam": {"exp_avg": {name: mu}, "exp_avg_sq": {name: nu}, "step":
    n}, "count": n}`` for ``adam_step`` (optax's ``ScaleByAdamState``
    and the schedule count), the parameters found by name through
    whatever ``freeze_sections`` wraps (None when the state has neither:
    weights-only artifacts).  ``generator`` is None: the JAX key is not
    carried."""
    if _field(state, "params") is None:             # bare params tree
        state = {"params": state}
    out: Dict[str, Any] = {
        "model": state_dict_from_flax({
            "params": _field(state, "params"),
            "batch_stats": _field(state, "batch_stats") or {}}),
        "generator": None,
        "optimizer": None,
    }
    step = _field(state, "step")
    if step is not None:
        out["step"] = int(_numpy(step))
    ema = _field(state, "ema_params")
    if ema is not None:
        out["ema_params"] = params_from_flax(ema)
    opt_state = _field(state, "opt_state")
    traces = optax_fields(opt_state, "trace")
    counts = optax_fields(opt_state, "count")
    count = int(_numpy(counts[-1])) if counts else 0
    adam = _adam_state(opt_state)
    if len(traces) == 1:
        out["optimizer"] = {"momentum": params_from_flax(traces[0]),
                            "count": count}
    elif adam is not None:
        out["optimizer"] = {"adam": {
            "exp_avg": params_from_flax(adam["mu"]),
            "exp_avg_sq": params_from_flax(adam["nu"]),
            "step": int(_numpy(adam["count"]))}, "count": count}
    b = _field(state, "boiw")
    out["boiw"] = None if b is None else {
        "embedding": torch.from_numpy(np.array(
            _numpy(_field(b, "embedding")), np.float32)),
        "ptr": torch.from_numpy(np.array(_numpy(_field(b, "ptr")),
                                         np.int64)),
        "proxies_prob": torch.from_numpy(np.array(
            _numpy(_field(b, "proxies_prob")), np.float32)),
        "beta": torch.tensor(float(_numpy(_field(b, "beta"))))}
    return out


def train_state_from_flax(state, model: nn.Module,
                          optimizer: torch.optim.Optimizer,
                          generator: torch.Generator) -> TrainState:
    """A port :class:`TrainState` over ``model`` / ``optimizer`` (the
    port's ``mp_det_sgd``, ``yolox_sgd`` or ``ScheduledAdam``) holding a
    JAX ``TrainState`` (the object of numpy leaves or its raw checkpoint
    tree): the weights and BN statistics are loaded into ``model``; the
    momentum trace becomes each parameter's ``momentum_buffer``, or Adam's
    ``mu``, ``nu`` and count its ``exp_avg``, ``exp_avg_sq`` and
    ``step``, and the schedule count ``optimizer.count``.  The JAX key is
    not carried: ``generator`` takes its place."""
    sd = checkpoint_from_flax(state)
    dev = next(model.parameters()).device
    target = TrainState.create(model, optimizer, generator)
    if sd["boiw"] is not None:
        target.boiw = BoIWState(**{k: v.to(dev)
                                   for k, v in sd["boiw"].items()})
    return load_state_dict(target, sd)
