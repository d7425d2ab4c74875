"""Counting the work of a call: its products and the bytes it moves.

:func:`count_cost` makes a :class:`CostCounter` active for the calls made
inside it.  Two sources feed it:

- every ATen operation the call dispatches, seen by a
  ``TorchDispatchMode`` after composite operations are decomposed (as
  ``FlopCounterMode`` sees them): its tensor arguments count as read and its tensor
  outputs as written (views and allocations move nothing), and the
  products among them (convolutions, matrix products) count 2 x their
  multiply-adds through ``torch.utils.flop_counter``'s formulas, with
  ``aten._int_mm`` registered here beside them;
- what dispatch cannot see, reported by the code that runs it: each
  hand-written kernel's wrapper, where it launches its kernel, reports the
  bytes its bound counts (and B4 its three convolutions' 2 x MACs), and
  ``ops/int8_conv.py: Int8Conv2d`` reports its convolution's 2 x MACs as
  int8 work, with the products of its padded GEMM (or of the CPU's
  float64 route) kept out of the count.

So ``flops`` is the model's work, the same whichever route runs it, and
``bytes`` is what the launched operations and kernels read and write,
which depends on the route.  Outside :func:`count_cost` nothing is
counted: a wrapper reads :func:`current` before it computes a report's
sizes, so a launch pays one module lookup.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten


class CostCounter:
    """``flops``: 2 x the multiply-adds of every product; ``int8_flops``:
    of them, the int8 ones; ``bytes``: read plus written."""

    def __init__(self):
        self.flops = 0.0
        self.int8_flops = 0.0
        self.bytes = 0.0
        self._quiet = 0          # > 0 inside a product reported whole
        self._paused = 0         # > 0 while a report computes its bytes

    def add(self, nbytes: float = 0.0, flops: float = 0.0,
            int8: bool = False) -> None:
        self.bytes += float(nbytes)
        self.flops += float(flops)
        if int8:
            self.int8_flops += float(flops)

    @contextlib.contextmanager
    def product(self, flops: float, int8: bool = False) -> Iterator[None]:
        """A product whose 2 x MACs its caller knows: counted once, here,
        and the products dispatched inside it not at all (their bytes
        still count)."""
        self.add(flops=flops, int8=int8)
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        """Operations that only compute a report: not counted."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "int8_flop_frac": (self.int8_flops / self.flops
                                   if self.flops else 0.0)}


_active: Optional[CostCounter] = None


def current() -> Optional[CostCounter]:
    """The counter of the enclosing :func:`count_cost`, or None."""
    return _active


def report(nbytes: float, flops: float = 0.0) -> None:
    """A kernel's launch: its bytes (and products) into the active
    counter, if any."""
    if _active is not None:
        _active.add(nbytes, flops)


def _int_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    m, k = a_shape
    return 2 * m * k * b_shape[1]


if aten._int_mm not in flop_counter.flop_registry:
    flop_counter.register_flop_formula(aten._int_mm)(_int_mm_flop)

# allocations and metadata: nothing read or written
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.lift_fresh,
               aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
               aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
               aten.set_}
_WRITE_ONLY = {aten.fill_, aten.zero_, aten.zeros, aten.zeros_like,
               aten.ones, aten.ones_like, aten.full, aten.full_like,
               aten.arange, aten.scalar_tensor}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor view addresses (a
    broadcast, stride-0 dimension counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class _CostMode(TorchDispatchMode):
    def __init__(self, counter: CostCounter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # a composite operation (conv2d in inference mode, linear) is
        # counted as the operations it decomposes into, as
        # FlopCounterMode counts it
        if func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        c = self.counter
        if c._paused or func.is_view or packet in _NO_TRAFFIC:
            return out
        written = _tensors(out)
        if packet is aten.copy_:
            read = _tensors(args[1:])
        elif packet in _WRITE_ONLY:
            read = []
        else:
            read = _tensors((args, {k: v for k, v in kwargs.items()
                                    if k != "out"}))
        c.bytes += sum(map(tensor_bytes, read + written))
        formula = flop_counter.flop_registry.get(packet)
        if formula is not None and not c._quiet:
            c.flops += formula(*args, **kwargs, out_val=out)
        return out


@contextlib.contextmanager
def count_cost() -> Iterator[CostCounter]:
    """Count the work of the calls made inside: ``with count_cost() as
    c: ...``, then ``c.flops``, ``c.bytes``, ``c.int8_flops``."""
    global _active
    counter = CostCounter()
    outer, _active = _active, counter
    try:
        with _CostMode(counter):
            yield counter
    finally:
        _active = outer
