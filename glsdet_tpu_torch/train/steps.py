"""The train steps of the three detector families, the counterparts of
``glsdet_tpu.train.steps``: ``make_yolox_train_step`` (SimOTA and the
YOLOX loss, the coarse detector's), ``make_mpdet_train_step`` (ATSS,
GFL and the proxy/BoIW/OT losses) and ``make_gfl_train_step`` (ATSS and
GFL, the MP-Det ablation baseline).

Batch dict contract (fixed shapes, tensors on the model's device):
    images:    (B, H, W, 3) uint8 RGB (``normalize=True``) or already
               normalised float32 (``normalize=False``)
    gt_boxes:  (B, G, 4) xyxy, zero-padded
    gt_labels: (B, G) int
    gt_valid:  (B, G) bool
and, from ``data/loader.py: TrainPipeline`` with ``device_color``, the
keys of the augmentations the step renders on the device
(``data/device_color.py: apply_batch_color``): ``mix_images`` /
``mix_weight``, ``hsv_deltas``, and ``geom_sources`` / ``geom_quads`` /
``geom_mat`` in place of ``images`` with ``device_geom``.

The step makes no host sync between taking the batch and returning the
metrics: every shape is fixed, nothing is read back, and the schedules
run on the host step count.  Under ``torch.cuda.set_sync_debug_mode(
"error")`` a change that adds one raises.

In a process group (``parallel/mesh.py``) each rank steps on its slice
of the global batch and the step is the JAX package's global-view step
on the whole batch: BatchNorm and the losses reduce over the group, so
each rank's loss is its share of the global loss (the OT loss, which
does not decompose, is computed whole on every rank with its gradient
flowing into the rank's own rows); one all-reduce per dtype then sums
the gradients, so clipping, the optimizer and the EMA see the global
gradient and every rank's state stays the same; the metrics are the
group's.  Over NCCL the collectives add no host sync.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from glsdet_tpu_torch.data.device_color import (apply_batch_color,
                                                imagenet_stats,
                                                normalize_images)
from glsdet_tpu_torch.models.detectors import GFL_STRIDES, YOLOX_STRIDES
from glsdet_tpu_torch.models.mp_head import proxy_class_matrix
from glsdet_tpu_torch.models.yolox_head import flatten_head_outputs
from glsdet_tpu_torch.ops.image import resize_bilinear
from glsdet_tpu_torch.ops.priors import grid_anchors, grid_points
from glsdet_tpu_torch.parallel import mesh
from glsdet_tpu_torch.train.gfl_loss import gfl_loss, gfl_targets
from glsdet_tpu_torch.train.mp_loss import mp_loss
from glsdet_tpu_torch.train.state import TrainState, apply_updates
from glsdet_tpu_torch.train.yolox_loss import yolox_loss


def _device_dtype(model: nn.Module):
    param = next(model.parameters())
    return param.device, param.dtype


def _gfl_anchors(img_hw, dev):
    """GFL anchors (octave scale 8) at ``img_hw``, their level counts,
    centres and strides, made once on ``dev``."""
    anchors_np, counts = grid_anchors(img_hw, GFL_STRIDES,
                                      octave_base_scale=8.0)
    anchors = torch.from_numpy(anchors_np).to(dev)
    centers = (anchors[:, :2] + anchors[:, 2:4]) / 2.0
    strides = torch.from_numpy(np.concatenate([
        np.full((n,), s, np.float32)
        for n, s in zip(counts, GFL_STRIDES)])).to(dev)
    return anchors, counts, centers, strides


def _flat_levels(maps, b):
    return torch.cat([m.reshape(b, -1, m.shape[-1]) for m in maps], dim=1)


def _step_end(state, total, new_boiw=None):
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    mesh.all_reduce_grads([p for g in state.optimizer.param_groups
                           for p in g["params"]])
    return apply_updates(state, new_boiw=new_boiw)


def make_yolox_train_step(model: nn.Module, img_hw: Tuple[int, int],
                          use_l1: bool = False,
                          strides: Tuple[int, ...] = YOLOX_STRIDES,
                          normalize: bool = False,
                          resize_from: Optional[Tuple[int, int]] = None,
                          bbox_loss_mode: str = "square",
                          dtype: torch.dtype = torch.float32) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)`` of the YOLOX
    recipe: the forward in training mode (under autocast to ``dtype``
    when it is not float32; the head outputs are cast to float32 for
    the loss), SimOTA and :func:`yolox_loss` (``use_l1`` for the last
    no-mosaic epochs, ``bbox_loss_mode``), one optimizer step and the
    EMA.  Metrics: ``loss``, ``loss_cls``, ``loss_bbox``, ``loss_obj``,
    ``loss_l1``, ``num_fg``, detached.

    ``resize_from``: batches arrive at this size and the step resizes
    the images to ``img_hw`` on the device as ``jax.image.resize``'s
    "bilinear" does (``ops/image.py: resize_bilinear``), between the
    color stage and the normalisation, and scales the GT boxes by the ratio: the
    multi-scale primitive (one base size from the loader, each target
    size its own step).  The priors are made once on the model's
    device; the images enter the model in its parameters' dtype."""
    dev, param_dtype = _device_dtype(model)
    centers_np, strides_np, _ = grid_points(img_hw, strides, offset=0.5)
    priors_cxy = torch.from_numpy(centers_np).to(dev)
    priors_stride = torch.from_numpy(strides_np).to(dev)
    do_resize = (resize_from is not None
                 and tuple(resize_from) != tuple(img_hw))
    if do_resize:
        sy = img_hw[0] / resize_from[0]
        sx = img_hw[1] / resize_from[1]
        box_scale = torch.tensor([sx, sy, sx, sy], dtype=torch.float32,
                                 device=dev)
    mean, std = imagenet_stats(dev)
    use_autocast = dtype != torch.float32

    def step(state: TrainState, batch: dict):
        model.train()
        images = apply_batch_color(batch, resize_from if do_resize
                                   else img_hw)
        gt_boxes = batch["gt_boxes"]
        if do_resize:
            images = resize_bilinear(images.float(), img_hw)
            gt_boxes = gt_boxes * box_scale.to(gt_boxes.dtype)
        images = normalize_images(images, normalize, mean, std)
        with torch.autocast(dev.type, dtype=dtype, enabled=use_autocast):
            cls_l, reg_l, obj_l = model(
                images.permute(0, 3, 1, 2).to(param_dtype))
        cls_f, reg_f, obj_f = flatten_head_outputs(cls_l, reg_l, obj_l)
        out = yolox_loss(cls_f.float(), reg_f.float(), obj_f.float(),
                         priors_cxy, priors_stride, gt_boxes,
                         batch["gt_labels"], batch["gt_valid"],
                         use_l1=use_l1, bbox_loss_mode=bbox_loss_mode)
        state = _step_end(state, out.total)
        metrics = {"loss": out.total, "loss_cls": out.loss_cls,
                   "loss_bbox": out.loss_bbox, "loss_obj": out.loss_obj,
                   "loss_l1": out.loss_l1, "num_fg": out.num_fg}
        metrics = mesh.reduce_metrics(metrics, replicated=("num_fg",))
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


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
    dev, param_dtype = _device_dtype(model)
    anchors, counts, centers, strides = _gfl_anchors(img_hw, dev)
    membership = torch.from_numpy(proxy_class_matrix(proxies_list)).to(dev)
    mean, std = imagenet_stats(dev)
    use_autocast = dtype != torch.float32

    def step(state: TrainState, batch: dict,
             noise: Optional[torch.Tensor] = None):
        model.train()
        targets = gfl_targets(anchors, counts, batch["gt_boxes"],
                              batch["gt_labels"], batch["gt_valid"],
                              num_classes)
        images = normalize_images(apply_batch_color(batch, img_hw),
                                  normalize, mean, std)
        with torch.autocast(dev.type, dtype=dtype, enabled=use_autocast):
            cls_l, bbox_l = model(images.permute(0, 3, 1, 2).to(param_dtype))
        b = images.shape[0]
        out = mp_loss(_flat_levels(cls_l, b), _flat_levels(bbox_l, b).float(),
                      model.head.proxies, membership,
                      state.boiw, state.generator, targets, centers,
                      strides, num_classes, proxies_list, reg_max=reg_max,
                      gamma=gamma, noise=noise)
        state = _step_end(state, out.total, new_boiw=out.boiw)
        metrics = {"loss": out.total, "loss_cls": out.loss_cls,
                   "loss_bbox": out.loss_bbox, "loss_dfl": out.loss_dfl,
                   "loss_emb": out.loss_emb, "loss_op": out.loss_op}
        # the OT loss is whole on every rank: count it once
        share = out.loss_cls + out.loss_bbox + out.loss_dfl + out.loss_emb
        metrics = mesh.reduce_metrics(dict(metrics, loss=share),
                                      replicated=("loss_op",))
        metrics["loss"] = metrics["loss"] + metrics["loss_op"]
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_gfl_train_step(model: nn.Module, img_hw: Tuple[int, int],
                        num_classes: int, reg_max: int = 16,
                        normalize: bool = False,
                        dtype: torch.dtype = torch.float32) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)`` of the plain
    GFL recipe (the MP-Det ablation baseline): ATSS targets, the forward
    in training mode (autocast as :func:`make_mpdet_train_step`), the
    GFL losses (QFL, GIoU, DFL) on float32 head outputs, one optimizer
    step and the EMA.  Metrics: ``loss``, ``loss_cls``, ``loss_bbox``,
    ``loss_dfl``, detached."""
    dev, param_dtype = _device_dtype(model)
    anchors, counts, centers, strides = _gfl_anchors(img_hw, dev)
    mean, std = imagenet_stats(dev)
    use_autocast = dtype != torch.float32

    def step(state: TrainState, batch: dict):
        model.train()
        targets = gfl_targets(anchors, counts, batch["gt_boxes"],
                              batch["gt_labels"], batch["gt_valid"],
                              num_classes)
        images = normalize_images(apply_batch_color(batch, img_hw),
                                  normalize, mean, std)
        with torch.autocast(dev.type, dtype=dtype, enabled=use_autocast):
            cls_l, bbox_l = model(images.permute(0, 3, 1, 2).to(param_dtype))
        b = images.shape[0]
        out = gfl_loss(_flat_levels(cls_l, b).float(),
                       _flat_levels(bbox_l, b).float(), targets, centers,
                       strides, num_classes, reg_max)
        state = _step_end(state, out.total)
        metrics = {"loss": out.total, "loss_cls": out.loss_cls,
                   "loss_bbox": out.loss_bbox, "loss_dfl": out.loss_dfl}
        metrics = mesh.reduce_metrics(metrics)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def stack_batches(batches) -> dict:
    """Stack K batch dicts of numpy arrays along a new leading axis."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}
