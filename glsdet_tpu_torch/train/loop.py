"""The training loop and its parts, the counterpart of
``glsdet_tpu.train.loop``: config -> model, optimizer, loader -> epochs
with hooks (reference: ``mmdet/apis/train.py:71`` and the GLSDet hooks):

- OptimalTransportHook: every ``ot_interval`` steps while the epoch is
  below ``ot_stop_epoch`` run ``update_ot``; at ``emd_start_epoch`` flip
  beta 0 -> 1;
- YOLOXModeSwitchHook: the last ``num_last_epochs`` epochs drop
  Mosaic/MixUp and add the L1 loss;
- CheckInvalidLossHook: a non-finite logged loss raises;
- ExpMomentumEMAHook: the EMA in ``state.apply_updates``;
- CheckpointHook / EvalHook: ``work_dir/epoch_{n}.pt`` and ``eval_fn``.

The hooks follow the JAX loop event for event (``tests/
test_torch_train_loop.py`` compares the two loops' event sequences with
their steps stubbed).  The loop reads the card only where the JAX loop
does: the loss every 10 steps and the metrics at ``log_interval``.

Every model family trains: ``yolox`` (with its ``variant``), ``ffa``
(the 4-level model at strides 4-32, the ``adam_step`` recipe), ``mpdet``
and ``gfl``.  ``train.steps_per_call = K > 1`` runs groups of K steps
back to back, with nothing read back between them, where a whole group
fits in the epoch and under ``max_steps`` (single steps elsewhere), and
the host hooks at group boundaries only (a hook fires when the step
count crosses a multiple of its interval), as the JAX loop's scan groups
(``make_scan_train_step`` there); a group reports its last step's
metrics, with the loss NaN if any of its K losses is not finite.

Across processes (``parallel/mesh.py``, one per card) ``cfg.data.
batch_size`` is the global batch, as in the JAX loop: each rank loads
``batch_size / W`` samples through ``DistributedGroupSampler`` (or
``InfiniteGroupBatchSampler``) with loader seed ``seed + rank``, the
state is broadcast from rank 0 after init, resume and load, and the step
is the global-batch step (``train/steps.py``).  Rank 0 alone logs, writes
checkpoints and runs ``eval_fn``; the other ranks wait for it at a
barrier at the end of each epoch.  One process trains on one card.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from glsdet_tpu_torch.config import Config
from glsdet_tpu_torch.data.coco import CocoDataset
from glsdet_tpu_torch.data.loader import (DistributedGroupSampler,
                                          InfiniteGroupBatchSampler,
                                          TrainPipeline, train_loader)
from glsdet_tpu_torch.models.build import build_model, resolve_device
from glsdet_tpu_torch.models.detectors import GFL_STRIDES, YOLOX_STRIDES
from glsdet_tpu_torch.parallel import mesh
from glsdet_tpu_torch.parallel.mesh import multiscale_size
from glsdet_tpu_torch.train import schedules
from glsdet_tpu_torch.train.boiw import (enable_emd_training, init_boiw,
                                         update_ot)
from glsdet_tpu_torch.train.state import (TrainState, load_state_dict,
                                          state_dict)
from glsdet_tpu_torch.train.steps import (make_gfl_train_step,
                                          make_mpdet_train_step,
                                          make_yolox_train_step)

logger = logging.getLogger("glsdet_tpu_torch")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def family_strides(family: str):
    """Head strides of a model family (ffa adds the P2 level): what
    ``make_yolox_train_step(strides=)`` takes for the config's model."""
    if family == "ffa":
        return (4, *YOLOX_STRIDES)
    if family in ("mpdet", "gfl"):
        return GFL_STRIDES
    return YOLOX_STRIDES


def freeze_sections(model: nn.Module, sections: Tuple[str, ...]
                    ) -> List[nn.Parameter]:
    """Freeze the top-level sections ``sections`` of ``model`` (their
    parameters stop taking gradients, so they get neither updates nor
    weight decay, while their BN statistics still move in the forward:
    yolox-drone train.py:228-230) and return the parameters left to
    train."""
    trainable = []
    for name, p in model.named_parameters():
        frozen = name.split(".")[0] in sections
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append(p)
    return trainable


def build_optimizer(cfg: Config, steps_per_epoch: int, model: nn.Module,
                    frozen_sections: Tuple[str, ...] = ()
                    ) -> torch.optim.Optimizer:
    """The optimizer ``cfg.train.optimizer`` names over ``model``'s
    parameters, with its schedule; the parameters of
    ``frozen_sections`` are frozen (:func:`freeze_sections`) and left
    out."""
    t = cfg.train
    total = t.max_iters or t.epochs * steps_per_epoch
    params = freeze_sections(model, tuple(frozen_sections))
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


# ── checkpoints ─────────────────────────────────────────────────────────
# one background writer at a time, joined by the next save or by
# finish_checkpoints (orbax's async save in the JAX package)
_writer_lock = threading.Lock()
_writer: Optional[threading.Thread] = None
_writer_error: List[BaseException] = []


def _write(sd: dict, path: str) -> None:
    try:
        tmp = path + ".tmp"
        torch.save(sd, tmp)
        os.replace(tmp, path)
    except BaseException as e:          # re-raised by finish_checkpoints
        _writer_error.append(e)


def finish_checkpoints() -> None:
    """Block until the checkpoint being written in the background is on
    disk; a failed write raises here."""
    global _writer
    with _writer_lock:
        if _writer is not None:
            _writer.join()
            _writer = None
        if _writer_error:
            raise RuntimeError("checkpoint write failed") from \
                _writer_error.pop()


def save_checkpoint(work_dir: str, state: TrainState, epoch: int,
                    wait: bool = True) -> str:
    """Write ``work_dir/epoch_{epoch}.pt`` (:func:`state.state_dict`,
    ``torch.save``).  The state is copied to host memory here; with
    ``wait=False`` the file is written on a thread that overlaps the
    next epoch, and the next save or :func:`finish_checkpoints` joins
    it."""
    global _writer
    finish_checkpoints()
    path = os.path.abspath(os.path.join(work_dir, f"epoch_{epoch}.pt"))
    sd = state_dict(state)
    with _writer_lock:
        _writer = threading.Thread(target=_write, args=(sd, path),
                                   daemon=False)
        _writer.start()
    if wait:
        finish_checkpoints()
    return path


def restore_raw(path: str) -> Dict:
    """A checkpoint file as saved (tensors on the CPU), or a plain
    state-dict file: the entry of checkpoint tooling and of weights-only
    loads.  A directory is read as an orbax checkpoint of the JAX
    package (``utils/orbax_read.py: read_orbax``: a ``TrainState``, a
    stripped artifact or a bare ``params`` tree) and given in the port's
    form (``utils/flax_import.py: checkpoint_from_flax``)."""
    if os.path.isdir(path):
        from glsdet_tpu_torch.utils.flax_import import checkpoint_from_flax
        from glsdet_tpu_torch.utils.orbax_read import read_orbax

        return checkpoint_from_flax(read_orbax(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, target: TrainState) -> TrainState:
    """Load a :func:`save_checkpoint` file into ``target`` in place:
    step, parameters and BN statistics, optimizer, EMA, generator and
    BoIW, bit for bit.  A JAX ``TrainState`` written by the JAX
    package's ``save_checkpoint`` loads as ``utils/flax_import.py:
    train_state_from_flax`` carries it (the generator stays
    ``target``'s)."""
    return load_state_dict(target, restore_raw(path))


# TrainState sections that hold model weights/statistics (vs. training
# trajectory: step / optimizer / generator); "model" is the JAX
# package's params and batch_stats
WEIGHT_SECTIONS = ("model", "ema_params", "boiw")


def load_weights(path: str, state: TrainState):
    """Weights-only, shape-matched partial load (mmdet ``load_from``,
    apis/train.py:199-202, + yolox-drone's partial state-dict load by
    shape match, train.py:139-165).

    Merges the ``model`` (parameters and BN statistics),
    ``ema_params`` and ``boiw`` tensors of a checkpoint into ``state``
    wherever the key exists and the shape matches; everything else
    (step, optimizer, generator, mismatched or missing tensors) keeps
    its value.  A plain state-dict file (``torch.save(model.
    state_dict())``, what ``apis.init_detector`` and ``serve.py`` read)
    is a ``model`` section, and a checkpoint without ``ema_params``
    seeds the EMA from its parameters.  A JAX orbax checkpoint maps its
    ``params`` and ``batch_stats`` onto ``model``, its ``ema_params`` and
    ``boiw`` onto the port's (:func:`restore_raw`).  Returns ``(state,
    n_loaded, skipped)``, ``skipped`` a list of ``(key, reason)``."""
    return merge_weights(restore_raw(path), state)


def merge_weights(raw: Dict, state: TrainState):
    """:func:`load_weights` of a checkpoint already read by
    :func:`restore_raw`."""
    if "model" not in raw:                  # bare state-dict artifact
        raw = {"model": raw}
    if raw.get("ema_params") is None:
        names = set(state.ema_params)
        raw = dict(raw, ema_params={k: v for k, v in raw["model"].items()
                                    if k in names})
    target = {
        "model": state.model.state_dict(),
        "ema_params": state.ema_params,
        "boiw": ({} if state.boiw is None else state.boiw._asdict()),
    }
    n_loaded, skipped = 0, []
    boiw = dict(target["boiw"])
    with torch.no_grad():
        for section in WEIGHT_SECTIONS:
            for key, val in (raw.get(section) or {}).items():
                name = f"{section}/{key}"
                cur = target[section].get(key)
                if cur is None:
                    skipped.append((name, "missing in model"))
                    continue
                if tuple(cur.shape) != tuple(val.shape):
                    skipped.append((name, f"shape {tuple(val.shape)} vs "
                                          f"{tuple(cur.shape)}"))
                    continue
                if section == "boiw":
                    boiw[key] = val.to(cur.device, cur.dtype)
                else:
                    cur.copy_(val)
                n_loaded += 1
    if state.boiw is not None:
        state.boiw = type(state.boiw)(**boiw)
    return state, n_loaded, skipped


# ── the loop ────────────────────────────────────────────────────────────

def train(cfg: Config, dataset: Optional[CocoDataset] = None,
          max_steps: Optional[int] = None,
          eval_fn: Optional[Callable] = None, device="cuda",
          device_geom: bool = False,
          param_dtype: torch.dtype = torch.float32) -> TrainState:
    """Run the training schedule of ``cfg`` on ``device``.
    ``max_steps`` truncates it (tests); ``eval_fn(state, epoch)`` is the
    EvalHook, called per epoch.

    ``cfg.train.freeze_epochs > 0`` selects the two-phase
    frozen-backbone recipe (yolox-drone train.py:196-262): phase 1
    trains ``freeze_epochs`` epochs at ``freeze_lr`` /
    ``freeze_batch_size`` with ``freeze_sections`` frozen, then phase 2
    builds a fresh optimizer and trains the remaining epochs unfrozen at
    ``base_lr`` / ``data.batch_size``; checkpoint, log and eval epochs
    are numbered across both.

    Options of the port (the JAX loop has none of them):
    ``device_geom`` renders the mosaic and affine warp on the card
    (``TrainPipeline(device_geom=True)``, the sources padded to the
    dataset's largest frame);
    ``param_dtype`` is the parameters' dtype (float64 for parity
    checks; the step computes under autocast to ``cfg.model.dtype``
    unless that is float32)."""
    if cfg.train.freeze_epochs > 0:
        if cfg.train.max_iters > 0:
            # each phase would otherwise apply the FULL max_iters budget
            raise ValueError(
                "train.max_iters (iteration-based mode) cannot be "
                "combined with train.freeze_epochs (the epoch-based "
                "two-phase freeze recipe)")
        return _train_two_phase(cfg, dataset, max_steps, eval_fn, device,
                                device_geom, param_dtype)
    return _train_run(cfg, dataset, max_steps, eval_fn, device, device_geom,
                      param_dtype)


def _train_two_phase(cfg: Config, dataset, max_steps, eval_fn, device,
                     device_geom, param_dtype):
    t = cfg.train
    if t.resume:
        raise ValueError(
            "resume with freeze_epochs is ambiguous (which phase?): "
            "resume the unfrozen phase explicitly with freeze_epochs=0, "
            "the reduced epoch count and resume=<ckpt> (the reference's "
            "manual Init_Epoch), or restart the two-phase run with "
            "load_from.")
    if t.freeze_epochs >= t.epochs:
        raise ValueError(f"freeze_epochs {t.freeze_epochs} must be < "
                         f"epochs {t.epochs}")

    p1 = copy.deepcopy(cfg)
    p1.train.epochs = t.freeze_epochs
    if t.freeze_lr:
        p1.train.base_lr = t.freeze_lr
    if t.freeze_batch_size:
        p1.data.batch_size = t.freeze_batch_size
    # the no-aug+L1 tail belongs to the END of the overall schedule
    p1.train.num_last_epochs = 0
    logger.info("freeze phase: %d epochs, lr %g, batch %d, frozen %s",
                p1.train.epochs, p1.train.base_lr, p1.data.batch_size,
                t.freeze_sections)
    state = _train_run(p1, dataset, max_steps, eval_fn, device, device_geom,
                       param_dtype, frozen_sections=tuple(t.freeze_sections))

    used = int(state.step)
    if max_steps is not None and used >= max_steps:
        return state

    p2 = copy.deepcopy(cfg)
    p2.train.epochs = t.epochs - t.freeze_epochs
    p2.train.load_from = ""     # weights carry over in memory
    logger.info("unfreeze phase: %d epochs, lr %g, batch %d",
                p2.train.epochs, p2.train.base_lr, p2.data.batch_size)
    return _train_run(p2, dataset,
                      None if max_steps is None else max_steps - used,
                      eval_fn, device, device_geom, param_dtype,
                      carry_state=state, epoch_offset=t.freeze_epochs)


def _make_steps(cfg: Config, model: nn.Module):
    """(step, step_l1, {size: (step, step_l1)}) of the config's family:
    the L1 twin for the last no-augmentation epochs (the family's own
    step where it has none) and one multiscale pair per size."""
    m, hw = cfg.model, tuple(cfg.data.img_hw)
    dtype = _DTYPES[m.dtype]
    if m.family == "mpdet":
        step = make_mpdet_train_step(model, hw, m.num_classes,
                                     m.proxies_list, reg_max=m.reg_max,
                                     gamma=m.gamma, normalize=True,
                                     dtype=dtype)
        return step, step, {}
    if m.family == "gfl":
        step = make_gfl_train_step(model, hw, m.num_classes,
                                   reg_max=m.reg_max, normalize=True,
                                   dtype=dtype)
        return step, step, {}
    strides = family_strides(m.family)

    def yolox(size, use_l1, resize_from=None):
        return make_yolox_train_step(
            model, size, use_l1=use_l1, strides=strides, normalize=True,
            resize_from=resize_from,
            bbox_loss_mode=cfg.train.bbox_loss_mode, dtype=dtype)

    ms = {s: (yolox((s, s), False, hw), yolox((s, s), True, hw))
          for s in cfg.train.multiscale_sizes or ()}
    return yolox(hw, False), yolox(hw, True), ms


def _check_supported(cfg: Config) -> None:
    """The JAX loop's ValueErrors, and the global batch's split."""
    t = cfg.train
    ms_sizes = tuple(t.multiscale_sizes or ())
    if ms_sizes:
        if cfg.model.family in ("mpdet", "gfl"):
            raise ValueError(
                "train.multiscale_sizes is a YOLOX-recipe feature "
                "(the MP-Det recipe trains fixed-size crops)")
        for s in ms_sizes:
            if s % 32:
                raise ValueError(f"multiscale size {s} not a 32-multiple")
    spc = max(int(t.steps_per_call), 1)
    if ms_sizes and spc > 1:
        raise ValueError(
            "train.multiscale_sizes requires steps_per_call=1 (per-size "
            "scan-group programs would multiply the compile budget; pick "
            "one of the two)")
    if spc > 1:
        for knob in ("ot_interval", "log_interval"):
            val = getattr(t, knob)
            if val % spc:
                raise ValueError(
                    f"train.{knob}={val} must be a multiple of "
                    f"train.steps_per_call={spc} (host hooks run at "
                    "scan-group boundaries)")
    world = mesh.world_size()
    if cfg.data.batch_size % world:
        raise ValueError(f"global batch {cfg.data.batch_size} not "
                         f"divisible by {world} processes")


def _train_run(cfg: Config, dataset: Optional[CocoDataset], max_steps,
               eval_fn, device, device_geom, param_dtype,
               frozen_sections: Tuple[str, ...] = (),
               carry_state: Optional[TrainState] = None,
               epoch_offset: int = 0) -> TrainState:
    """One optimizer lifetime (single-phase training and each phase of
    the freeze recipe).  ``carry_state`` seeds the model (parameters and
    BN statistics), EMA, BoIW and generator from the previous phase
    under a fresh optimizer at step 0; ``epoch_offset`` keeps the epoch
    numbering continuous across phases."""
    dev = resolve_device(device)
    _check_supported(cfg)
    t = cfg.train
    os.makedirs(t.work_dir, exist_ok=True)
    log_path = os.path.join(t.work_dir, "train.log.json")

    if dataset is None:
        dataset = CocoDataset(cfg.data.ann_file, cfg.data.img_root,
                              filter_empty=True,
                              cache_images=cfg.data.cache_images,
                              cache_bytes=cfg.data.cache_bytes)
    geom_src_hw = None
    if device_geom:
        geom_src_hw = (max(r.height for r in dataset.records),
                       max(r.width for r in dataset.records))
    pipeline = TrainPipeline(
        dataset, cfg.data.img_hw, cfg.data.max_gt,
        mosaic=cfg.data.mosaic, enable_mixup=cfg.data.mixup,
        hsv=cfg.data.hsv, flip_prob=cfg.data.flip_prob,
        raw_uint8=True, device_color=cfg.data.device_color,
        device_geom=device_geom, geom_src_hw=geom_src_hw)
    steps_per_epoch = max(len(dataset) // cfg.data.batch_size, 1)
    # iteration-based mode (mmdet IterBasedRunner analog): an exact
    # optimizer-step budget on the infinite grouped sample stream
    iter_based = t.max_iters > 0
    if iter_based:
        max_steps = (t.max_iters if max_steps is None
                     else min(max_steps, t.max_iters))

    if carry_state is None:
        model = build_model(cfg, dev, generator=torch.Generator().manual_seed(
            t.seed)).to(param_dtype)
    else:
        model = carry_state.model
    opt = build_optimizer(cfg, steps_per_epoch, model,
                          frozen_sections=frozen_sections)
    if carry_state is None:
        generator = torch.Generator(device=dev).manual_seed(t.seed)
        state = make_state_template(cfg, model, opt, generator)
    else:
        # phase handoff: weights, statistics, EMA, dictionary and
        # generator continue; the optimizer starts afresh at step 0
        state = TrainState(step=0, model=model, optimizer=opt,
                           ema_params=carry_state.ema_params,
                           generator=carry_state.generator,
                           boiw=carry_state.boiw)
    # every rank starts from rank 0's state (a no-op in one process)
    state = mesh.replicate(state)

    if t.resume:
        state = restore_checkpoint(t.resume, state)
        logger.info("resumed from %s at step %d", t.resume, state.step)
    elif t.load_from:   # resume wins, like mmdet apis/train.py
        state, n_loaded, skipped = load_weights(t.load_from, state)
        logger.info("loaded %d weight arrays from %s (%d skipped)",
                    n_loaded, t.load_from, len(skipped))
        for key, reason in skipped:
            logger.info("  skipped %s: %s", key, reason)
    if t.resume or t.load_from:
        state = mesh.replicate(state)

    step_fn, step_fn_l1, ms_steps = _make_steps(cfg, model)
    ms_sizes = tuple(t.multiscale_sizes or ())
    # K steps a group (train.steps_per_call); hooks at group boundaries
    spc = max(int(t.steps_per_call), 1)

    # each rank loads its slice of the global batch
    world, rank = mesh.world_size(), mesh.rank()
    is_main = rank == 0
    local_batch = cfg.data.batch_size // world
    sampler = None
    if iter_based:
        sampler = InfiniteGroupBatchSampler(
            dataset, local_batch, num_replicas=world, rank=rank,
            seed=t.seed)
    elif world > 1:
        sampler = DistributedGroupSampler(
            dataset, local_batch, num_replicas=world, rank=rank,
            seed=t.seed)
    if world > 1 and is_main:
        logger.info("data parallel: %d processes, %d samples each",
                    world, local_batch)
    loader = train_loader(pipeline, local_batch, seed=t.seed + rank,
                          num_workers=cfg.data.num_workers, sampler=sampler,
                          pin_memory=dev.type == "cuda")

    def put_batch(batch):
        return {k: v.to(dev, non_blocking=True) for k, v in batch.items()}

    start_epoch = state.step // steps_per_epoch
    global_step = state.step
    t_iter = time.time()
    ot_rng = np.random.RandomState(t.seed + 1)

    n_epochs = t.epochs
    if iter_based:
        # enough epoch-shaped chunks to cover the step budget; the
        # max_steps check inside the loop stops exactly at max_iters
        n_epochs = start_epoch - (-max_steps // steps_per_epoch) + 1
    try:
        for epoch in range(start_epoch, n_epochs):
            gepoch = epoch + epoch_offset
            # the last-epochs mode switch (no-aug + L1) is an epoch-recipe
            # feature; iter-based runs keep augmentation on throughout
            last_phase = (not iter_based
                          and epoch >= t.epochs - t.num_last_epochs)
            if last_phase:
                pipeline.disable_aug()
            fn = step_fn_l1 if last_phase else step_fn

            # OT hook: beta switch at emd_start_epoch (mpdet only)
            if (cfg.model.family == "mpdet"
                    and gepoch == t.emd_start_epoch
                    and state.boiw is not None):
                state.boiw = enable_emd_training(state.boiw)
                logger.info("epoch %d: enabled emd training (beta=1)",
                            gepoch)

            it = 0
            while it < steps_per_epoch:
                if max_steps is not None and global_step >= max_steps:
                    return state
                # a group only where a whole one fits; the epoch's and
                # max_steps' tails run as single steps
                stepped = (spc if spc > 1 and it + spc <= steps_per_epoch
                           and (max_steps is None
                                or global_step + spc <= max_steps) else 1)
                if stepped > 1:
                    logger.debug("step %d: group of %d steps", global_step,
                                 stepped)
                losses = []
                for _ in range(stepped):
                    batch = put_batch(next(loader))
                    if ms_steps:
                        s = multiscale_size(global_step, ms_sizes,
                                            t.multiscale_interval)
                        logger.debug("step %d: multiscale size %d",
                                     global_step, s)
                        sized = ms_steps[s]
                        fn_ms = sized[1] if last_phase else sized[0]
                        state, metrics = fn_ms(state, batch)
                    else:
                        state, metrics = fn(state, batch)
                    losses.append(metrics["loss"])
                if stepped > 1:
                    # the last step's metrics; a non-finite loss at any
                    # of the K steps trips the invalid-loss check now
                    metrics = dict(metrics, loss=torch.where(
                        torch.isfinite(torch.stack(losses)).all(),
                        metrics["loss"], float("nan")))
                it += stepped
                global_step += stepped

                # the JAX loop's periodic read bounds the work in flight:
                # "crossed a multiple of 10" (% 10 == 0 for single steps)
                if global_step % 10 < stepped:
                    float(metrics["loss"])

                # OT hook: update_ot every ot_interval while epoch < stop
                # (crossing, as above: an epoch's tail of single steps
                # may leave the count off the group stride)
                if (cfg.model.family == "mpdet"
                        and gepoch < t.ot_stop_epoch
                        and global_step % t.ot_interval < stepped):
                    gen = torch.Generator(device=dev).manual_seed(
                        int(ot_rng.randint(2 ** 31)))
                    state.boiw = update_ot(state.boiw, gen,
                                           cfg.model.proxies_list)
                    # the k-means may sum in another order on each card
                    mesh.broadcast_(state.boiw)
                    if is_main:
                        logger.info("step %d: ran update_ot", global_step)

                if global_step % t.log_interval < stepped:
                    vals = {k: float(v) for k, v in metrics.items()}
                    # CheckInvalidLossHook analog
                    if not np.isfinite(vals["loss"]):
                        raise FloatingPointError(
                            f"non-finite loss at step {global_step}: {vals}")
                    dt = (time.time() - t_iter) / t.log_interval
                    t_iter = time.time()
                    entry = {"mode": "train", "epoch": gepoch + 1,
                             "iter": it, "step": global_step,
                             "time": round(dt, 4), **vals}
                    if is_main:
                        logger.info("%s", entry)
                        with open(log_path, "a") as f:
                            f.write(json.dumps(entry) + "\n")

            # the state is the same on every rank: rank 0 alone writes
            # and evaluates while the others wait here, not in a step
            if is_main and (gepoch + 1) % t.ckpt_interval == 0:
                # the write overlaps the next epoch (joined by the next
                # save or by finish_checkpoints below)
                save_checkpoint(t.work_dir, state, gepoch + 1, wait=False)
            if is_main and eval_fn is not None:
                eval_fn(state, gepoch + 1)
            mesh.barrier()
        return state
    finally:
        loader.close()
        finish_checkpoints()
