"""Config -> head strides, optimizer and train state, the counterparts
of ``family_strides``, ``build_optimizer`` and ``make_state_template``
in ``glsdet_tpu.train.loop``.  The loop itself (``train()``, checkpoints,
loaders, the hooks' cadence) comes with the data pipeline (ROADMAP.md,
queue A item 11); until then a caller drives the step and the OT hook
(``update_ot`` every ``train.ot_interval`` steps while the epoch is
below ``train.ot_stop_epoch``, ``enable_emd_training`` at
``train.emd_start_epoch``) itself, as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from glsdet_tpu_torch.config import Config
from glsdet_tpu_torch.models.detectors import GFL_STRIDES, YOLOX_STRIDES
from glsdet_tpu_torch.train import schedules
from glsdet_tpu_torch.train.boiw import init_boiw
from glsdet_tpu_torch.train.state import TrainState


def family_strides(family: str):
    """Head strides of a model family (ffa adds the P2 level): what
    ``make_yolox_train_step(strides=)`` takes for the config's model."""
    if family == "ffa":
        return (4, *YOLOX_STRIDES)
    if family in ("mpdet", "gfl"):
        return GFL_STRIDES
    return YOLOX_STRIDES


def build_optimizer(cfg: Config, steps_per_epoch: int, model: nn.Module
                    ) -> torch.optim.Optimizer:
    """The optimizer ``cfg.train.optimizer`` names over ``model``'s
    parameters, with its schedule (the freeze recipe's
    ``frozen_sections`` comes with the loop, ROADMAP.md queue A item
    12)."""
    t = cfg.train
    total = t.max_iters or t.epochs * steps_per_epoch
    params = list(model.parameters())
    if t.optimizer == "yolox_sgd":
        sched = schedules.yolox_warm_cos(
            t.base_lr, t.warmup_epochs * steps_per_epoch, total,
            t.num_last_epochs * steps_per_epoch, t.min_lr_ratio)
        return schedules.yolox_sgd(params, sched,
                                   weight_decay=t.weight_decay)
    if t.optimizer == "mp_sgd":
        sched = schedules.schedule_1x(t.base_lr, steps_per_epoch)
        return schedules.mp_det_sgd(params, sched,
                                    weight_decay=t.weight_decay,
                                    grad_clip=t.grad_clip or 35.0)
    if t.optimizer == "adam_step":
        sched = schedules.epoch_step_decay(t.base_lr, steps_per_epoch)
        return schedules.ScheduledAdam(params, sched,
                                       weight_decay=t.weight_decay)
    raise ValueError(t.optimizer)


def make_state_template(cfg: Config, model: nn.Module,
                        optimizer: torch.optim.Optimizer,
                        generator: torch.Generator) -> TrainState:
    """A fresh :class:`TrainState`; MP-Det configs carry a BoIW
    dictionary drawn from ``generator`` (on its device), the YOLOX and
    GFL families none."""
    boiw = None
    if cfg.model.family == "mpdet":
        boiw = init_boiw(generator, cfg.model.num_classes,
                         cfg.model.num_words, cfg.model.feat_channels,
                         cfg.model.proxies_list, device=generator.device)
    return TrainState.create(model, optimizer, generator, boiw=boiw)
