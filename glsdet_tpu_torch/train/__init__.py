"""Training: the YOLOX (SimOTA), MP-Det and plain GFL losses, targets and
steps, the BoIW dictionary, schedules, state and the loop with its
checkpoints (the counterpart of ``glsdet_tpu.train``)."""

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
from glsdet_tpu_torch.train.steps import (make_gfl_train_step,
                                          make_mpdet_train_step,
                                          make_yolox_train_step,
                                          stack_batches)
from glsdet_tpu_torch.train.yolox_loss import (YOLOXLossOut, yolox_loss,
                                               yolox_loss_3assign,
                                               yolox_loss_decoupled,
                                               yolox_loss_fpn_weight)

__all__ = [
    "BoIWState", "enable_emd_training", "init_boiw", "update_dictionary",
    "update_ot", "GFLLossOut", "GFLTargets", "gfl_loss", "gfl_targets",
    "MPLossOut", "contrastive_loss", "mp_loss", "ot_proxy_loss",
    "ema_momentum", "epoch_step_decay", "mp_det_sgd", "schedule_1x",
    "yolox_sgd", "yolox_warm_cos", "TrainState", "apply_updates",
    "make_gfl_train_step", "make_mpdet_train_step", "make_yolox_train_step",
    "stack_batches", "YOLOXLossOut", "yolox_loss", "yolox_loss_3assign",
    "yolox_loss_decoupled", "yolox_loss_fpn_weight",
]
