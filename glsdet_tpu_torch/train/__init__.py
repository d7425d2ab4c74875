"""Training: MP-Det's losses, targets, BoIW dictionary, schedules, state
and step (the counterpart of ``glsdet_tpu.train``; the YOLOX and plain
GFL trainers are still to be ported)."""

from glsdet_tpu_torch.train.boiw import (BoIWState, enable_emd_training,
                                         init_boiw, update_dictionary,
                                         update_ot)
from glsdet_tpu_torch.train.gfl_loss import (GFLLossOut, GFLTargets,
                                             gfl_loss, gfl_targets)
from glsdet_tpu_torch.train.mp_loss import (MPLossOut, contrastive_loss,
                                            mp_loss, ot_proxy_loss)
from glsdet_tpu_torch.train.schedules import (ema_momentum, epoch_step_decay,
                                              mp_det_sgd, schedule_1x,
                                              yolox_sgd, yolox_warm_cos)
from glsdet_tpu_torch.train.state import TrainState, apply_updates
from glsdet_tpu_torch.train.steps import make_mpdet_train_step, stack_batches

__all__ = [
    "BoIWState", "enable_emd_training", "init_boiw", "update_dictionary",
    "update_ot", "GFLLossOut", "GFLTargets", "gfl_loss", "gfl_targets",
    "MPLossOut", "contrastive_loss", "mp_loss", "ot_proxy_loss",
    "ema_momentum", "epoch_step_decay", "mp_det_sgd", "schedule_1x",
    "yolox_sgd", "yolox_warm_cos", "TrainState", "apply_updates",
    "make_mpdet_train_step", "stack_batches",
]
