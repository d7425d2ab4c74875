"""Learning-rate schedules and the optimizers of the training recipes,
the counterparts of ``glsdet_tpu.train.schedules``.

Schedules are plain functions of the step, computed in float32 on the
host as the JAX package computes them in float32 on the device; the
step lives on the host, so reading the learning rate never waits for
the card.

- ``yolox_warm_cos``: quadratic warmup -> cosine -> constant floor for
  the last no-augmentation epochs (YOLOX's lr hook);
- ``epoch_step_decay``: x0.92 per epoch (the drone trainer's StepLR);
- ``schedule_1x``: linear warmup (500 steps from 0.001) and x0.1 at
  epochs 8 and 11 (mmdet's ``schedule_1x``, the MP-Det recipe).

The optimizers follow optax's order: ``mp_det_sgd`` clips by global norm
(optax's formula: ``g / |g| * max_norm`` once ``|g| >= max_norm``), then
adds the weight decay of every parameter, then SGD momentum;
``yolox_sgd`` decays only rank >= 2 tensors and uses Nesterov momentum.
Each step reads the learning rate at the optimizer's update count
*before* the update, as optax's ``scale_by_schedule`` does.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

_F = np.float32


def yolox_warm_cos(base_lr: float, warmup_steps: int, total_steps: int,
                   no_aug_steps: int, min_lr_ratio: float = 0.05
                   ) -> Callable[[int], float]:
    min_lr = _F(base_lr * min_lr_ratio)
    base = _F(base_lr)
    cos_steps = _F(max(total_steps - no_aug_steps - warmup_steps, 1))

    def sched(step):
        step = _F(step)
        warm = base * np.square(
            np.clip(step / _F(max(warmup_steps, 1)), _F(0), _F(1)))
        t = np.clip((step - _F(warmup_steps)) / cos_steps, _F(0), _F(1))
        cos = min_lr + _F(0.5) * (base - min_lr) * (
            _F(1) + np.cos(_F(np.pi) * t))
        lr = warm if step < warmup_steps else cos
        return float(min_lr if step >= total_steps - no_aug_steps else lr)

    return sched


def epoch_step_decay(base_lr: float, steps_per_epoch: int,
                     gamma: float = 0.92) -> Callable[[int], float]:
    def sched(step):
        epoch = _F(step) // _F(steps_per_epoch)
        return float(_F(base_lr) * np.power(_F(gamma), epoch))

    return sched


def schedule_1x(base_lr: float, steps_per_epoch: int,
                warmup_steps: int = 500, warmup_ratio: float = 0.001,
                milestones=(8, 11)) -> Callable[[int], float]:
    def sched(step):
        step = _F(step)
        alpha = np.clip(step / _F(max(warmup_steps, 1)), _F(0), _F(1))
        warm_f = _F(warmup_ratio) * (_F(1) - alpha) + alpha
        epoch = step // _F(steps_per_epoch)
        decay = np.power(_F(0.1), _F(sum(epoch >= m for m in milestones)))
        return float(_F(base_lr) * warm_f * decay)

    return sched


def ema_momentum(step, base_momentum: float = 0.0002,
                 gamma: float = 2000.0) -> float:
    """ExpMomentumEMAHook's decay, m(t) = (1 - m0) exp(-(1 + t) / gamma)
    + m0, in float32."""
    m0 = _F(base_momentum)
    return float((_F(1) - m0) * np.exp(-(_F(1) + _F(step)) / _F(gamma))
                 + m0)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: when the global norm
    reaches ``max_norm``, each gradient becomes ``g / norm * max_norm``.
    No host sync: the choice is a ``torch.where`` on the card."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm).to(norm))


class _Scheduled:
    """Mixin of a torch optimizer: the learning rate of every group is
    ``schedule(count)`` at each step, ``count`` the number of steps taken
    before it, and gradients are clipped by global norm first when
    ``grad_clip`` is set."""

    def _setup(self, schedule, grad_clip: Optional[float]) -> None:
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        if self.grad_clip:
            clip_by_global_norm_(
                [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None], self.grad_clip)
        lr = self.schedule(self.count)
        for group in self.param_groups:
            group["lr"] = lr
        out = super().step(closure)
        self.count += 1
        return out


class ScheduledSGD(_Scheduled, torch.optim.SGD):
    def __init__(self, params, schedule, momentum: float = 0.9,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 grad_clip: Optional[float] = None):
        super().__init__(params, lr=schedule(0), momentum=momentum,
                         weight_decay=weight_decay, nesterov=nesterov)
        self._setup(schedule, grad_clip)


class ScheduledAdam(_Scheduled, torch.optim.Adam):
    def __init__(self, params, schedule, weight_decay: float = 0.0):
        super().__init__(params, lr=schedule(0), weight_decay=weight_decay)
        self._setup(schedule, None)


def mp_det_sgd(params: Iterable[torch.nn.Parameter], schedule,
               momentum: float = 0.9, weight_decay: float = 1e-4,
               grad_clip: float = 35.0) -> ScheduledSGD:
    """The MP-Det recipe: clip by global norm 35 -> weight decay 1e-4 on
    every parameter -> SGD momentum 0.9."""
    return ScheduledSGD(params, schedule, momentum=momentum,
                        weight_decay=weight_decay, grad_clip=grad_clip)


def yolox_sgd(params: Iterable[torch.nn.Parameter], schedule,
              momentum: float = 0.9, weight_decay: float = 5e-4,
              nesterov: bool = True) -> ScheduledSGD:
    """The YOLOX recipe: SGD with Nesterov momentum, weight decay on the
    rank >= 2 tensors (convolution kernels) only."""
    params = list(params)
    groups = [{"params": [p for p in params if p.ndim >= 2],
               "weight_decay": weight_decay},
              {"params": [p for p in params if p.ndim < 2],
               "weight_decay": 0.0}]
    return ScheduledSGD([g for g in groups if g["params"]], schedule,
                        momentum=momentum, nesterov=nesterov)
