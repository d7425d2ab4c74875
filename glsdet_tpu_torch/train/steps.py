"""The MP-Det train step, the counterpart of ``glsdet_tpu.train.steps``
(``make_mpdet_train_step``; the YOLOX and plain GFL steps are still to
be ported, ROADMAP.md queue A item 12).

Batch dict contract (fixed shapes, tensors on the model's device):
    images:    (B, H, W, 3) uint8 RGB (``normalize=True``) or already
               normalised float32 (``normalize=False``)
    gt_boxes:  (B, G, 4) xyxy, zero-padded
    gt_labels: (B, G) int
    gt_valid:  (B, G) bool

The step makes no host sync between taking the batch and returning the
metrics: every shape is fixed, nothing is read back, and the schedules
run on the host step count.  Under ``torch.cuda.set_sync_debug_mode(
"error")`` a change that adds one raises.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from glsdet_tpu_torch.data.device_color import (apply_batch_color,
                                                imagenet_stats,
                                                normalize_images)
from glsdet_tpu_torch.models.detectors import GFL_STRIDES
from glsdet_tpu_torch.models.mp_head import proxy_class_matrix
from glsdet_tpu_torch.ops.priors import grid_anchors
from glsdet_tpu_torch.train.gfl_loss import gfl_targets
from glsdet_tpu_torch.train.mp_loss import mp_loss
from glsdet_tpu_torch.train.state import TrainState, apply_updates



def make_mpdet_train_step(model: nn.Module, img_hw: Tuple[int, int],
                          num_classes: int, proxies_list: Sequence[int],
                          reg_max: int = 16, gamma: float = 10.0,
                          normalize: bool = False,
                          dtype: torch.dtype = torch.float32) -> Callable:
    """Returns ``step(state, batch, noise=None) -> (state, metrics)``:
    ATSS targets, the forward in training mode (under autocast to
    ``dtype`` when it is not float32; parameters and losses stay
    float32), GFL + proxy/BoIW/OT losses, one optimizer step and the
    EMA.  ``noise`` (num_classes + 1, B * A) replaces the dictionary
    update's uniform draw from ``state.generator`` (tests feed the JAX
    package's).  The anchors, their centres and strides and the
    proxy-class membership are made once, on the model's device.  The
    images enter the model in its parameters' dtype (a float64 model is
    how the CPU tests hold the gradients to the JAX package's)."""
    param = next(model.parameters())
    dev, param_dtype = param.device, param.dtype
    anchors_np, counts = grid_anchors(img_hw, GFL_STRIDES,
                                      octave_base_scale=8.0)
    anchors = torch.from_numpy(anchors_np).to(dev)
    centers = (anchors[:, :2] + anchors[:, 2:4]) / 2.0
    strides = torch.from_numpy(np.concatenate([
        np.full((n,), s, np.float32)
        for n, s in zip(counts, GFL_STRIDES)])).to(dev)
    membership = torch.from_numpy(proxy_class_matrix(proxies_list)).to(dev)
    mean, std = imagenet_stats(dev)
    use_autocast = dtype != torch.float32

    def step(state: TrainState, batch: dict,
             noise: Optional[torch.Tensor] = None):
        model.train()
        targets = gfl_targets(anchors, counts, batch["gt_boxes"],
                              batch["gt_labels"], batch["gt_valid"],
                              num_classes)
        images = normalize_images(apply_batch_color(batch),
                                  normalize, mean, std)
        with torch.autocast(dev.type, dtype=dtype, enabled=use_autocast):
            cls_l, bbox_l = model(images.permute(0, 3, 1, 2).to(param_dtype))
        b = images.shape[0]
        cls_feats = torch.cat([f.reshape(b, -1, f.shape[-1]) for f in cls_l],
                              dim=1)
        bbox_preds = torch.cat([p.reshape(b, -1, p.shape[-1])
                                for p in bbox_l], dim=1).float()
        out = mp_loss(cls_feats, bbox_preds, model.head.proxies, membership,
                      state.boiw, state.generator, targets, centers,
                      strides, num_classes, proxies_list, reg_max=reg_max,
                      gamma=gamma, noise=noise)
        state.optimizer.zero_grad(set_to_none=True)
        out.total.backward()
        state = apply_updates(state, new_boiw=out.boiw)
        metrics = {"loss": out.total, "loss_cls": out.loss_cls,
                   "loss_bbox": out.loss_bbox, "loss_dfl": out.loss_dfl,
                   "loss_emb": out.loss_emb, "loss_op": out.loss_op}
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def stack_batches(batches) -> dict:
    """Stack K batch dicts of numpy arrays along a new leading axis."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}
