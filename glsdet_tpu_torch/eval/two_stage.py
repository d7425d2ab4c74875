"""Two-stage UFPMP inference, the counterpart of
``glsdet_tpu.eval.two_stage.TwoStagePipeline``.

Per frame: coarse YOLOX on the resized frame -> decode + NMS -> UFP
packing on the host (C++, a thread pool across frames) -> mosaic painting
and normalizing (one CUDA kernel launch per bucket group) -> MP-Det on
the mosaic -> GFL decode + NMS -> chip unmap + IoF gate + class-wise NMS
-> with ``fuse_global``, global-local fusion of each frame's mosaic set
with its coarse set (one more class-wise NMS).  The preprocessing chains
are ``eval/preprocess.py``.

Packing, as in the JAX package: ``pack_mode="square"`` (the default: the
reference's near-square layout, bucketed afterwards) or ``"bucket-fit"``
(packed at the ladder's widths); ``bucket_policy="image"`` (each frame's
smallest covering bucket) or ``"chunk-max"`` (a chunk's mosaics all at
its largest bucket, one stage-2 group).

On the card the models run in bfloat16 with cuDNN convolutions, and both
stages run in ``torch.inference_mode()``.  On the CPU (the parity tests)
everything runs in float32 and the kernels' plain versions take over.

int8 serving, as in the JAX package: ``quant8="static"`` with the
``act_scales`` that :meth:`TwoStagePipeline.calibrate_int8` returns
(``ops/quant_static.py``), or ``quant8=True``, dynamic W8A8
(``ops/quant.py``).

Fused bottlenecks, as in the JAX package, take no knob: hand the pipeline
a wrapped MP-Det, ``TwoStagePipeline(coarse, wrap_model_fused(mp), ...)``
(``ops/fused_infer.py``), and its 12 identity ResNet blocks run as the
fused kernel (``csrc/bottleneck.cu``).  The pipeline's cast of the model
to bfloat16 leaves the folded biases in float32.  Fused serving is float
only: a wrapped MP-Det with ``quant8`` raises.

Several cards, as in the JAX package: ``devices=["cuda:0", "cuda:1",
...]`` serves each ``submit_batch`` on the next card of the list in turn
(round robin; the stages of a batch stay on its card).  Each card holds
its own copy of the stage nets (float, int8 or fused) and of the
normalisation constants, made at construction from the first card's: the
int8 copies are quantized once, on the first card, so every card serves
the same codes from the same scales.  No collective runs: batches are
independent.

``scan_width``, as in the JAX package: a chunk of ``b`` frames (or a
stage-2 bucket group of ``b`` mosaics) with ``b > scan_width`` and ``b %
scan_width == 0`` runs its stage in ``b / scan_width`` groups of
``scan_width``, one after the other, their outputs concatenated on the
card: one read-back per chunk and per stage-2 group as without groups,
while the live activations are one group's.  The JAX pipeline pads each
chunk to a power of two first; the port does not pad, so the rule applies
to the chunk as it runs (a chunk of 24 at ``scan_width=16`` runs flat).
Each group launches the painter once.

:meth:`TwoStagePipeline.cost_analysis` gives the products and bytes per
image of the two stages (``eval/cost.py``).
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from glsdet_tpu_torch.eval.fusion import fuse_detections_batch
from glsdet_tpu_torch.eval.postprocess import (gfl_postprocess,
                                               yolox_postprocess)
from glsdet_tpu_torch.eval.preprocess import coarse_inputs, norm_constants
from glsdet_tpu_torch.models.build import resolve_device
from glsdet_tpu_torch.native import (unified_foreground_packing_rows,
                                     unified_foreground_packing_rows_fit)
from glsdet_tpu_torch.ops.fused_infer import FusedBottleneck
from glsdet_tpu_torch.ops.nms import NEG_INF, batched_nms, topk_stable
from glsdet_tpu_torch.ops.quant import quantize_dynamic
from glsdet_tpu_torch.ops.quant_static import (calibrate_scales,
                                               quantize_static)
from glsdet_tpu_torch.ufp.assembly import (regions_to_array,
                                           unmap_chip_detections_argmax)
from glsdet_tpu_torch.ufp.paint_kernel import paint_mosaic_inputs_cuda

# Model-canvas buckets (multiples of 128, the coarsest pyramid stride).
DEFAULT_BUCKETS = (768, 1024, 1152, 1280, 1536, 1792, 2688)


def pick_bucket(h: float, w: float, buckets: Sequence[int]) -> int:
    """Smallest bucket covering (h, w); larger mosaics are clipped."""
    need = max(h, w)
    for b in buckets:
        if need <= b:
            return b
    return buckets[-1]


def pack_detections(boxes, scores, labels, valid) -> torch.Tensor:
    """One (..., K, 7) float32 array ``[x1, y1, x2, y2, score, label,
    valid]``: a detection set comes back to the host in one transfer."""
    return torch.cat([boxes.float(), scores.float()[..., None],
                      labels.float()[..., None], valid.float()[..., None]],
                     dim=-1)


def unpack_detections(packed: np.ndarray) -> dict:
    """numpy inverse of :func:`pack_detections`."""
    packed = np.asarray(packed)
    return {"boxes": packed[..., :4], "scores": packed[..., 4],
            "labels": packed[..., 5].astype(np.int64),
            "valid": packed[..., 6] > 0.5}


def _scale_packed(packed: np.ndarray, sx: float, sy: float) -> np.ndarray:
    """Packed detections (..., K, 7) with their box columns scaled from
    the coarse input to frame coordinates (a copy, on the host)."""
    out = np.array(packed, np.float32, copy=True)
    out[..., :4] *= np.array([sx, sy, sx, sy], np.float32)
    return out


def _coarse_row_dets(row7: np.ndarray, sx: float, sy: float) -> dict:
    """One frame's coarse detections as a result dict in frame
    coordinates: what ``fuse_global`` serves for a frame whose UFP
    packing found no foreground region."""
    d = unpack_detections(_scale_packed(row7, sx, sy))
    v = d["valid"]
    return {"boxes": d["boxes"][v], "scores": d["scores"][v],
            "labels": d["labels"][v]}


def _fuse_packed(gdets, boxes, scores, labels, valid,
                 iou_thr: float = 0.65, max_out: int = 500):
    """Global-local fusion of a stage-2 group: ``gdets`` (b, Kg, 7), the
    frames' packed coarse detections in frame coordinates, and the
    group's unmapped detections (b, K, ...) -> one class-wise NMS (offset
    0) over the Kg + K rows and the top ``max_out``."""
    g = {"boxes": gdets[..., :4], "scores": gdets[..., 4],
         "labels": gdets[..., 5].to(labels.dtype),
         "valid": gdets[..., 6] > 0.5}
    d = fuse_detections_batch(g, {"boxes": boxes, "scores": scores,
                                  "labels": labels, "valid": valid},
                              iou_thr, max_out)
    return d["boxes"], d["scores"], d["labels"], d["valid"]


def _collapse_jobs_to_max_bucket(jobs: Dict[int, list]) -> Dict[int, list]:
    """``bucket_policy="chunk-max"``: every mosaic job of a chunk runs at
    the chunk's largest bucket, as one stage-2 group.  Results are keyed
    by frame index, so the order within the group is free."""
    if len(jobs) <= 1:
        return jobs
    merged: List[tuple] = []
    for bk in sorted(jobs):
        merged.extend(jobs[bk])
    return {max(jobs): merged}


def _unmap_and_nms(det_boxes, det_scores, det_labels, det_valid, regions,
                   iou_thr: float = 0.6, max_out: int = 500):
    """Chip unmap + IoF gate + class-wise NMS, batched over (B, ...).

    offset=1.0: the reference driver's chip NMS uses the legacy +1
    pixel-area convention."""
    boxes, valid = unmap_chip_detections_argmax(det_boxes, det_valid,
                                                regions)
    scores = torch.where(valid, det_scores, NEG_INF)
    keep, _ = batched_nms(boxes, scores, det_labels, iou_thr, offset=1.0)
    out_scores, idx = topk_stable(torch.where(keep, scores, NEG_INF),
                                  max_out)
    out_valid = out_scores > NEG_INF / 2
    return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
            torch.where(out_valid, out_scores, 0.0),
            torch.gather(det_labels, 1, idx), out_valid)


def _device_key(device: torch.device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _on(device: torch.device):
    """Make ``device`` current for the work of a stage (a no-op on the
    CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _BatchHandle:
    """In-flight batch of the submit / dispatch / collect protocol."""

    __slots__ = ("shapes", "chunks", "pending", "fallbacks", "dispatched")

    def __init__(self, shapes, chunks):
        self.shapes = shapes        # per-frame (h0, w0)
        self.chunks = chunks        # (frame indices, device stack, coarse)
        self.pending = []           # (frame index, stage-2 result, slot)
        self.fallbacks = []         # (frame index, coarse dets): no regions
        self.dispatched = False


class TwoStagePipeline:
    """End-to-end UFPMP inference over (B, H, W, 3) uint8 RGB frames.

    ``coarse_model`` (a ``YOLOXDetector``) and ``mp_model`` (an
    ``MPDet``), with float32 weights, are moved to ``device`` in place and
    put in eval mode: bfloat16 on ``"cuda"``, float32 on ``"cpu"``.
    ``device="cuda"`` without a GPU raises; nothing falls back to the CPU.

    ``quant8``: False (the float models) | True (dynamic W8A8) |
    ``"static"`` (calibrated W8A8 with an explicit int8 ResNet and int8
    head towers).  ``"static"`` serves int8 when ``act_scales`` is the
    ``(coarse_scales, mp_scales)`` pair of :meth:`calibrate_int8` (or of
    the JAX package's, or ``load_scales``); with ``act_scales=None`` it
    serves the float models, the calibration vehicle.  The quantized
    copies (``coarse_net``/``mp_net``) and their int8 weights are built
    once, here, from the float32 weights; the float models stay, in
    ``coarse``/``mp``, for calibration.

    ``fuse_global``: fuse each frame's mosaic detections with its coarse
    ones (class-wise NMS at ``fusion_nms_thr``, offset 0); a frame with
    no foreground region then returns its coarse set.  ``pack_mode`` and
    ``bucket_policy`` as in the module docstring; both raise the JAX
    package's ``ValueError`` on other values.

    ``devices``: a list of devices (``torch.device`` s or strings, all of
    one type) to serve on in turn, in place of ``device`` (module
    docstring); ``coarse``/``mp``, ``coarse_net``/``mp_net`` are the
    first device's.  A device may be listed twice (two turns of one
    card share its copy).  ``scan_width``: a positive int or None
    (module docstring).
    """

    def __init__(self, coarse_model: torch.nn.Module,
                 mp_model: torch.nn.Module, coarse_hw: Tuple[int, int],
                 num_classes: int = 10, ufp_scale: float = 1.5,
                 max_regions: int = 32,
                 mosaic_buckets: Sequence[int] = DEFAULT_BUCKETS,
                 coarse_score_thr: float = 0.3,
                 chip_score_thr: float = 0.01, final_nms_thr: float = 0.6,
                 max_coarse_dets: int = 200, max_chip_dets: int = 500,
                 max_batch: int = 4, pack_threads: Optional[int] = None,
                 quant8=False, act_scales=None, fuse_global: bool = False,
                 fusion_nms_thr: float = 0.65, bucket_policy: str = "image",
                 pack_mode: str = "square", device="cuda", devices=None,
                 scan_width: Optional[int] = None):
        if devices:
            devices = [_device_key(resolve_device(d)) for d in devices]
            if len({d.type for d in devices}) > 1:
                raise ValueError(f"devices {devices}: expected devices of "
                                 "one type")
            device = devices[0]
        self.device = resolve_device(device)
        self.devices = list(devices) if devices else [
            _device_key(self.device)]
        self._turns = itertools.cycle(self.devices)
        self._pinned = False        # calibrating: every batch on devices[0]
        if scan_width is not None and int(scan_width) < 1:
            raise ValueError(f"scan_width {scan_width!r}: expected a "
                             "positive int or None")
        self.scan_width = int(scan_width) if scan_width else None
        if self.device.type == "cuda":
            # float32 math stays float32 (the proxy-score products and
            # the decode); the bfloat16 convolutions are unaffected
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            self.dtype = torch.bfloat16
        else:
            self.dtype = torch.float32
        if bucket_policy not in ("image", "chunk-max"):
            raise ValueError(f"bucket_policy {bucket_policy!r}: expected "
                             "'image' or 'chunk-max'")
        if pack_mode not in ("square", "bucket-fit"):
            raise ValueError(f"pack_mode {pack_mode!r}: expected "
                             "'square' or 'bucket-fit'")
        if quant8 not in (False, True, "static"):
            raise ValueError(f"quant8 {quant8!r}: expected False, True or "
                             "'static'")
        if quant8 and any(isinstance(m, FusedBottleneck)
                          for m in mp_model.modules()):
            raise ValueError("fused bottlenecks serve in float only: "
                             "quant8 must be False")
        self.quant8 = quant8
        # built before the float models are cast: the int8 weights come
        # from the float32 parameters, as in the JAX package
        nets = (coarse_model, mp_model)
        place = dict(dtype=self.dtype, device=self.device)
        if quant8 == "static" and act_scales is not None:
            nets = (quantize_static(coarse_model, act_scales[0], **place),
                    quantize_static(mp_model, act_scales[1], **place))
        elif quant8 is True:
            nets = (quantize_dynamic(coarse_model, **place),
                    quantize_dynamic(mp_model, **place))
        self.coarse = coarse_model.to(self.device, self.dtype).eval()
        self.mp = mp_model.to(self.device, self.dtype).eval()
        self.coarse_net, self.mp_net = nets       # what the stages run
        self._capture = None        # (coarse inputs, mosaic inputs) lists
        self.coarse_hw = tuple(coarse_hw)
        self.num_classes = num_classes
        self.ufp_scale = ufp_scale
        self.max_regions = max_regions
        self.buckets = tuple(mosaic_buckets)
        self.coarse_score_thr = coarse_score_thr
        self.chip_score_thr = chip_score_thr
        self.final_nms_thr = final_nms_thr
        self.max_coarse = max_coarse_dets
        self.max_chip = max_chip_dets
        self.max_batch = max(1, int(max_batch))
        self.fuse_global = bool(fuse_global)
        self.fusion_nms_thr = fusion_nms_thr
        self.bucket_policy = bucket_policy
        self.pack_mode = pack_mode
        # made here, so that the stages copy nothing to the card
        self._mean, self._inv_std = norm_constants(self.dtype, self.device)
        # per device: (coarse_net, mp_net, mean, inv_std), the first
        # device's the ones above, the others' copies of them
        first = self.devices[0]
        self._replicas = {first: (self.coarse_net, self.mp_net, self._mean,
                                  self._inv_std)}
        for d in self.devices:
            if d not in self._replicas:
                self._replicas[d] = (copy.deepcopy(self.coarse_net).to(d),
                                     copy.deepcopy(self.mp_net).to(d),
                                     *norm_constants(self.dtype, d))
        # host UFP packing pool: frames pack independently and the C++
        # packer releases the GIL; None = min(8, cpus), <= 1 = inline
        if pack_threads is None:
            pack_threads = min(8, os.cpu_count() or 1)
        self._pack_pool = (ThreadPoolExecutor(
            pack_threads, thread_name_prefix="glsdet-ufp-pack")
            if pack_threads > 1 else None)

    def close(self) -> None:
        """Stop the host packing threads."""
        if self._pack_pool is not None:
            self._pack_pool.shutdown(wait=True)
            self._pack_pool = None

    # -- devices ---------------------------------------------------------

    def _replica(self, device: torch.device) -> tuple:
        """(coarse_net, mp_net, mean, inv_std) of ``device``."""
        rep = self._replicas.get(_device_key(device))
        if rep is None:
            raise ValueError(f"device {device} is not one of the pipeline's "
                             f"devices {self.devices}")
        return rep

    def _next_device(self) -> torch.device:
        return self.devices[0] if self._pinned else next(self._turns)

    def _groups(self, b: int) -> List[slice]:
        """The ``scan_width`` groups of a stage of width ``b`` (the JAX
        rule: ``b > scan_width`` and a multiple of it), else all of it."""
        w = self.scan_width
        if w and b > w and b % w == 0:
            return [slice(s, s + w) for s in range(0, b, w)]
        return [slice(0, b)]

    # -- device stages -------------------------------------------------

    @torch.inference_mode()
    def coarse_packed(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 device frames -> (B, max_coarse_dets, 7)
        packed coarse detections in coarse-input coordinates, on the
        frames' device, in ``scan_width`` groups where they apply."""
        net = self._replica(imgs.device)[0]
        with _on(imgs.device):
            outs = [self._coarse_group(net, imgs[g])
                    for g in self._groups(imgs.shape[0])]
            return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _coarse_group(self, net, imgs: torch.Tensor) -> torch.Tensor:
        x = coarse_inputs(imgs, self.coarse_hw, self.dtype)
        if self._capture is not None:
            self._capture[0].append(x)
        cls, reg, obj = net(x)
        d = yolox_postprocess(cls, reg, obj, self.coarse_hw,
                              score_thr=self.coarse_score_thr,
                              max_dets=self.max_coarse)
        return pack_detections(d["boxes"], d["scores"], d["labels"],
                               d["valid"])

    @torch.inference_mode()
    def stage2_packed(self, imgs: torch.Tensor, idx: torch.Tensor,
                      regions: torch.Tensor, hw: int,
                      gdets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Paint, MP-Det, decode + NMS, unmap + NMS for one bucket group,
        then, given ``gdets``, global-local fusion.

        imgs (N, H, W, 3) uint8 frames; idx (b,) int64 frame of each
        mosaic; regions (b, R, 7) float32 rows; gdets (b,
        max_coarse_dets, 7) the mosaics' frames' packed coarse detections
        in frame coordinates.  Returns (b, max_chip_dets, 7) packed
        detections in frame coordinates, on the frames' device, in
        ``scan_width`` groups where they apply."""
        rep = self._replica(imgs.device)
        with _on(imgs.device):
            outs = [self._stage2_group(
                rep, imgs, idx[g], regions[g], hw,
                None if gdets is None else gdets[g])
                for g in self._groups(idx.shape[0])]
            return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _stage2_group(self, rep, imgs, idx, regions, hw, gdets):
        _, net, mean, inv_std = rep
        # one painter launch writes the normalized NHWC input (on the
        # CPU: mosaic_inputs_plain); MP-Det reads it as channels-last NCHW
        x = paint_mosaic_inputs_cuda(imgs, idx, regions, hw, mean,
                                     inv_std).permute(0, 3, 1, 2)
        if self._capture is not None:
            self._capture[1].append(x)
        cls, reg = net(x)
        d = gfl_postprocess(cls, reg, (hw, hw),
                            score_thr=self.chip_score_thr,
                            max_dets=self.max_chip)
        out = _unmap_and_nms(d["boxes"], d["scores"], d["labels"],
                             d["valid"], regions, iou_thr=self.final_nms_thr,
                             max_out=self.max_chip)
        if gdets is not None:
            out = _fuse_packed(gdets, *out, iou_thr=self.fusion_nms_thr,
                               max_out=self.max_chip)
        return pack_detections(*out)

    def capture_inputs(self, images: Sequence[np.ndarray]):
        """One ``run_batch`` over ``images`` on the first device, returning
        the model inputs the stages saw: (normalized coarse batches,
        normalized mosaic canvases), NCHW on that device."""
        coarse_in: List[torch.Tensor] = []
        mosaic_in: List[torch.Tensor] = []
        self._capture = (coarse_in, mosaic_in)
        self._pinned = True
        try:
            self.run_batch(list(images))
        finally:
            self._capture = None
            self._pinned = False
        return coarse_in, mosaic_in

    def calibrate_int8(self, images: Sequence[np.ndarray],
                       min_channels: int = 32):
        """Static-int8 activation scales for both models: the float models
        are calibrated (``calibrate_scales``) on the inputs one
        ``run_batch`` over the sample frames gives them.  Returns
        ``(coarse_scales, mp_scales)`` for ``TwoStagePipeline(...,
        quant8="static", act_scales=...)``; ``save_scales`` persists them.
        Build this pipeline without quantization, and keep the sample
        small: the captured inputs stay on the device until the
        calibration ends.  With ``devices`` it runs on the first one."""
        coarse_in, mosaic_in = self.capture_inputs(images)
        return (calibrate_scales(self.coarse, coarse_in, min_channels),
                calibrate_scales(self.mp, mosaic_in, min_channels))

    # -- streaming protocol --------------------------------------------

    def __call__(self, image: np.ndarray) -> dict:
        """One (H, W, 3) uint8 frame -> dict(boxes, scores, labels)."""
        return self.run_batch([image])[0]

    def run_batch(self, images: Sequence[np.ndarray]) -> List[dict]:
        """Host frames -> per-frame detection dicts (numpy, frame
        coordinates).  Frames are grouped by shape into chunks of up to
        ``max_batch``."""
        h = self.submit_batch(images)
        self.dispatch_mosaics(h)
        return self.collect_batch(h)

    def submit_batch(self, images: Sequence[np.ndarray]) -> _BatchHandle:
        """Phase 1: upload shape-grouped chunks and run their coarse
        stage, the whole batch on the next device in turn."""
        target = self._next_device()
        by_shape: Dict[tuple, List[int]] = {}
        for i, img in enumerate(images):
            by_shape.setdefault(np.shape(img), []).append(i)
        chunks = []
        for idxs in by_shape.values():
            for s in range(0, len(idxs), self.max_batch):
                part = idxs[s:s + self.max_batch]
                stack = torch.from_numpy(np.stack(
                    [np.asarray(images[i], np.uint8) for i in part]))
                dev = stack.to(target)
                chunks.append((part, dev, self.coarse_packed(dev)))
        return _BatchHandle([np.shape(im)[:2] for im in images], chunks)

    def submit_device_batch(self, dev_stack: torch.Tensor) -> _BatchHandle:
        """Phase 1 for a (B, H, W, 3) uint8 stack already on one of the
        pipeline's devices, which serves it."""
        b, h0, w0 = dev_stack.shape[:3]
        chunk = (list(range(b)), dev_stack, self.coarse_packed(dev_stack))
        return _BatchHandle([(h0, w0)] * b, [chunk])

    def _pack_chunk(self, shapes, part, dets) -> Dict[int, list]:
        """UFP-pack a chunk's frames on the host; mosaic jobs
        ``(frame index, chunk row, rows)`` by bucket.  A frame with no
        foreground region has no job."""
        ch, cw = self.coarse_hw

        def pack_one(item):
            row, i = item
            h0, w0 = shapes[i]
            sx, sy = w0 / cw, h0 / ch
            boxes = (dets["boxes"][row]
                     * np.array([sx, sy, sx, sy], np.float32))[
                         dets["valid"][row]]
            if self.pack_mode == "bucket-fit":
                return unified_foreground_packing_rows_fit(
                    boxes, self.ufp_scale, (w0, h0), self.max_regions,
                    self.buckets)
            return unified_foreground_packing_rows(
                boxes, self.ufp_scale, (w0, h0),
                self.max_regions) + (None,)

        items = list(enumerate(part))
        packs = (list(self._pack_pool.map(pack_one, items))
                 if self._pack_pool is not None
                 else [pack_one(it) for it in items])
        jobs: Dict[int, list] = {}
        for (row, i), (rows, n_reg, mw, mh, bucket) in zip(items, packs):
            if n_reg == 0:
                continue
            if bucket is None:
                bucket = pick_bucket(mh, mw, self.buckets)
            jobs.setdefault(bucket, []).append((i, row, rows))
        if self.bucket_policy == "chunk-max":
            jobs = _collapse_jobs_to_max_bucket(jobs)
        return jobs

    def dispatch_mosaics(self, h: _BatchHandle) -> None:
        """Phase 2: read each chunk's coarse detections (one transfer),
        pack on the host, run the stage-2 group of every bucket.  With
        ``fuse_global`` the group's coarse sets, scaled to frame
        coordinates here, go up with its rows, and a frame without
        regions takes its coarse set as its result."""
        ch, cw = self.coarse_hw
        for part, dev, packed in h.chunks:
            target = dev.device         # stage 2 follows the chunk
            packed_np = packed.cpu().numpy()
            jobs = self._pack_chunk(h.shapes, part,
                                    unpack_detections(packed_np))
            if self.fuse_global:
                in_jobs = {j[0] for job_list in jobs.values()
                           for j in job_list}
                for row, i in enumerate(part):
                    if i not in in_jobs:
                        h0, w0 = h.shapes[i]
                        h.fallbacks.append((i, _coarse_row_dets(
                            packed_np[row], w0 / cw, h0 / ch)))
            for bucket, job_list in jobs.items():
                rows = [j[1] for j in job_list]
                idx = torch.tensor(rows, dtype=torch.int64).to(target)
                regs = torch.from_numpy(
                    np.stack([j[2] for j in job_list])).to(target)
                gdets = None
                if self.fuse_global:
                    h0, w0 = h.shapes[part[0]]
                    gdets = torch.from_numpy(_scale_packed(
                        packed_np[rows], w0 / cw, h0 / ch)).to(target)
                out = self.stage2_packed(dev, idx, regs, bucket, gdets)
                h.pending.extend((j[0], out, slot)
                                 for slot, j in enumerate(job_list))
        h.dispatched = True

    def collect_batch(self, h: _BatchHandle) -> List[dict]:
        """Phase 3: read the stage-2 results (one transfer per group)."""
        if not h.dispatched:
            self.dispatch_mosaics(h)
        empty = {"boxes": np.zeros((0, 4), np.float32),
                 "scores": np.zeros((0,), np.float32),
                 "labels": np.zeros((0,), np.int64)}
        results: List[dict] = [empty] * len(h.shapes)
        for i, det in h.fallbacks:
            results[i] = det
        fetched: Dict[int, dict] = {}
        for i, out, slot in h.pending:
            if id(out) not in fetched:
                fetched[id(out)] = unpack_detections(out.cpu().numpy())
            d = fetched[id(out)]
            v = d["valid"][slot]
            results[i] = {"boxes": d["boxes"][slot][v],
                          "scores": d["scores"][slot][v],
                          "labels": d["labels"][slot][v]}
        return results

    def run_device_batch(self, dev_stack: torch.Tensor) -> List[dict]:
        """Inference on a device-resident (B, H, W, 3) uint8 stack."""
        return self.run_device_batches([dev_stack])[0]

    def run_device_batches(self, stacks: Sequence[torch.Tensor]
                           ) -> List[List[dict]]:
        """Several device stacks: every coarse stage runs before any
        packing, every stage-2 group before any result is read."""
        handles = [self.submit_device_batch(s) for s in stacks]
        for h in handles:
            self.dispatch_mosaics(h)
        return [self.collect_batch(h) for h in handles]

    def warmup(self, image_hw: Tuple[int, int]) -> None:
        """Run both stages on blank inputs, per bucket, at batch 1 and
        ``max_batch`` (the batch sizes ``run_batch`` hits, as the JAX
        package's warmup), the fusion included with ``fuse_global``, on
        every device: loads the kernels library (building it on first
        use), initialises cuDNN and the CUDA context, and grows the
        caching allocator to a full batch, so the first served batch pays
        none of it."""
        regs = torch.from_numpy(regions_to_array([], self.max_regions))
        for dev in self._replicas:
            for b in sorted({1, self.max_batch}):
                frames = torch.zeros((b, *image_hw, 3), dtype=torch.uint8,
                                     device=dev)
                self.coarse_packed(frames)
                idx = torch.zeros((b,), dtype=torch.int64, device=dev)
                regs_b = regs.expand(b, -1, -1).contiguous().to(dev)
                gdets = (torch.zeros((b, self.max_coarse, 7), device=dev)
                         if self.fuse_global else None)
                for bucket in self.buckets:
                    self.stage2_packed(frames, idx, regs_b, bucket, gdets)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def cost_analysis(self, image_hw: Tuple[int, int],
                      bucket: Optional[int] = None,
                      batch: Optional[int] = None) -> dict:
        """Per image, the work of the two stages at the shapes
        ``run_batch`` gives them, as the JAX package's ``cost_analysis``:
        ``{"batch", "bucket", "coarse": {...}, "stage2": {...}}``, each
        stage ``flops``, ``bytes`` and ``int8_flop_frac``
        (``eval/cost.py: stage_costs`` says what each counts)."""
        from glsdet_tpu_torch.eval.cost import stage_costs

        return stage_costs(self, image_hw, bucket, batch)
