"""High-level inference APIs, the counterparts of ``glsdet_tpu.apis``: the
mmdet ``apis`` and yolox-drone ``YOLO`` facade analogs.

Behavioral references:
- ``mmdet/apis/inference.py:17,89`` (init_detector / inference_detector).
- ``yolox-drone/yolo.py:19`` (YOLO predictor: detect_image, get_FPS,
  get_map_txt writing ``detection-results/<id>.txt`` lines
  ``<class_name> <conf> <x1> <y1> <x2> <y2>``).

Every entry point takes ``device`` (default ``"cuda"``; ``"cuda"``
without a GPU raises, nothing falls back to the CPU).  On the card the
models compute in bfloat16, on the CPU in float32.

A checkpoint is either a file of a model's ``state_dict()``
(``torch.save``), loaded strictly, or a training checkpoint that
``train/loop.py: save_checkpoint`` wrote, loaded shape-matched through
``load_weights``, whose EMA weights serve when ``use_ema`` is set, or a
directory the JAX package's orbax checkpointer wrote (a ``TrainState`` or
a ``tools/ckpt_tool.py strip`` artifact), read without JAX by
``utils/orbax_read.py`` and loaded as a training checkpoint.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from glsdet_tpu_torch.config import apply_overrides, get_config
from glsdet_tpu_torch.data.coco import IMAGENET_MEAN, IMAGENET_STD
from glsdet_tpu_torch.data.visdrone import VISDRONE_CLASSES
from glsdet_tpu_torch.eval.postprocess import (gfl_postprocess,
                                               yolox_postprocess)
from glsdet_tpu_torch.eval.two_stage import (TwoStagePipeline,
                                             pack_detections,
                                             unpack_detections)
from glsdet_tpu_torch.models.build import build_model, resolve_device
from glsdet_tpu_torch.ops.image import resize_linear_u8
from glsdet_tpu_torch.ops.quant import quantize_dynamic
from glsdet_tpu_torch.ops.quant_static import (calibrate_scales, load_scales,
                                               quantize_static, save_scales)


def init_detector(config_name: str, checkpoint: Optional[str] = None,
                  use_ema: bool = True, options: Optional[dict] = None,
                  device="cuda"):
    """Build a model from a named config and an optional checkpoint.

    Returns ``(cfg, model, state_dict)``: the float32 model in eval mode
    on ``device``, with the checkpoint's weights or, without one, the
    seeded initialisation of ``models/build.py``.  A state-dict file
    loads strictly (a mismatch raises ``ValueError``).  A training
    checkpoint, or a file of weight sections (``{"model": ...[,
    "ema_params", "boiw"]}``, what ``tools/ckpt_tool.py strip`` and
    ``tools/import_torch_weights.py`` write) or a JAX orbax checkpoint
    directory loads as the JAX package's does: shape-matched through
    ``train/loop.py: load_weights`` (mismatched tensors keep their
    initialisation, no match at all raises ``ValueError``), then the
    parameters are the checkpoint's EMA with ``use_ema`` and its raw
    parameters without; BN statistics are the checkpoint's either
    way."""
    cfg = get_config(config_name)
    if options:
        apply_overrides(cfg, options)
    model = build_model(cfg, device)
    if checkpoint:
        load_checkpoint(cfg, model, checkpoint, use_ema)
    return cfg, model.eval(), model.state_dict()


def load_checkpoint(cfg, model, checkpoint: str, use_ema: bool = True,
                    strict: bool = True) -> None:
    """Load ``checkpoint`` into ``model`` (built from ``cfg``) in place,
    as :func:`init_detector` describes.  With ``strict=False`` a bare
    state-dict file loads shape-matched too, as ``tools/test.py`` loads
    it."""
    from glsdet_tpu_torch.train.loop import (build_optimizer,
                                             make_state_template,
                                             merge_weights, restore_raw)

    raw = restore_raw(checkpoint)
    if strict and "model" not in raw:     # a bare state dict
        try:
            model.load_state_dict(raw, strict=True)
        except RuntimeError as e:
            raise ValueError(f"{checkpoint} does not hold the weights of "
                             f"{cfg.name}: {e}") from e
        return
    gen = torch.Generator(device=next(model.parameters()).device)
    state = make_state_template(cfg, model, build_optimizer(cfg, 1000, model),
                                gen)
    state, n_loaded, skipped = merge_weights(raw, state)
    if n_loaded == 0:
        raise ValueError(f"no weight arrays in {checkpoint} match "
                         f"{cfg.name}: {skipped[:5]}")
    if use_ema:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(state.ema_params[name])


def _dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _scales_arg(quant8, int8_scales):
    """(saved-scales path or None, scales or None) for ``quant8`` and
    ``int8_scales`` (a JSON path, existing or not, or the scales)."""
    path = int8_scales if isinstance(int8_scales, str) else None
    scales = None
    if quant8 == "static":
        if path and os.path.exists(path):
            scales = load_scales(path)
        elif int8_scales is not None and not path:
            scales = int8_scales
    return path, scales


class Detector:
    """Single-model predictor facade (yolo.py:19 YOLO class analog).

    ``quant8``: False | True (dynamic W8A8) | ``"static"``.  Static int8
    serves with ``int8_scales`` (a saved-scales JSON path or the scales
    dict) when there are any; else the first ``detect``/``detect_batch``
    calibrates on its own inputs and, when ``int8_scales`` names a path
    that does not exist yet, saves the scales there.  Serves the
    ``yolox`` family with any ``variant``, ``mpdet`` and ``gfl``; family
    ``ffa`` raises ``ValueError``, as the JAX facade fails on it."""

    # class-level default so hand-assembled instances (built with
    # ``__new__``) skip the lazy int8 calibration
    _needs_calibration = False

    def __init__(self, config_name: str, checkpoint: Optional[str] = None,
                 class_names: Optional[Sequence[str]] = None,
                 score_thr: Optional[float] = None,
                 use_ema: bool = True,
                 quant8=False,
                 int8_scales=None,
                 options: Optional[dict] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dtype = _dtype(self.device)
        # float32 on the CPU: the int8 copies are made from it there
        cfg, model, _ = init_detector(config_name, checkpoint, use_ema,
                                      options, "cpu")
        if cfg.model.family == "ffa":
            # the JAX facade decodes every family but yolox as (cls, reg)
            # and so fails on the 4-level model's (cls, reg, obj)
            raise ValueError(
                f"{config_name}: family 'ffa' is not served by Detector, as "
                "in the JAX package; evaluate it with eval/runner.py: "
                "run_eval(..., family='ffa')")
        self.quant8 = quant8
        self.cfg = cfg
        self.class_names = list(class_names or VISDRONE_CLASSES)
        self.score_thr = (score_thr if score_thr is not None
                          else cfg.eval.score_thr)
        self._scales_path, scales = _scales_arg(quant8, int8_scales)
        self._needs_calibration = quant8 == "static" and scales is None
        place = dict(dtype=self.dtype, device=self.device)
        if self._needs_calibration:
            self._model = model              # for the int8 copy
            self._net = None
        elif quant8 == "static":
            self._net = quantize_static(model, scales, **place)
        elif quant8:
            self._net = quantize_dynamic(model, **place)
        else:
            self._net = model.to(self.device, self.dtype)
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)

    def _calibrate(self, batch: torch.Tensor) -> None:
        """``batch``: the normalized input the first request produced, the
        calibration set."""
        # calibrated in the serving dtype; the int8 copy is made from the
        # float32 weights
        scales = calibrate_scales(
            copy.deepcopy(self._model).to(self.device, self.dtype), [batch])
        if self._scales_path:
            save_scales(self._scales_path, scales)
        self._net = quantize_static(self._model, scales, dtype=self.dtype,
                                    device=self.device)
        self._model = None
        self._needs_calibration = False

    @torch.inference_mode()
    def _fwd(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, 3, h, w) model input -> (B, max_dets, 7) packed dets."""
        cfg = self.cfg
        img_hw = tuple(cfg.data.img_hw)
        kw = dict(score_thr=self.score_thr, iou_thr=cfg.eval.nms_iou,
                  max_dets=cfg.eval.max_dets)
        if cfg.model.family == "yolox":
            cls, reg, obj = self._net(batch)
            d = yolox_postprocess(cls, reg, obj, img_hw, **kw)
        else:
            cls, reg = self._net(batch)
            d = gfl_postprocess(cls, reg, img_hw, **kw)
        return pack_detections(d["boxes"], d["scores"], d["labels"],
                               d["valid"])

    def _inputs(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """Frames -> the model's (B, 3, h, w) input on the device: each
        resized as ``cv2.resize`` (``ops/image.py``), then ``(x - mean) /
        std`` in float32 (``data/coco.py: normalize``), cast once."""
        h, w = self.cfg.data.img_hw
        x = torch.stack([resize_linear_u8(torch.from_numpy(
            np.ascontiguousarray(im, np.uint8)).to(self.device), (h, w))
            for im in images])
        x = (x.float() - self._mean) / self._std
        return x.to(self.dtype).permute(0, 3, 1, 2)

    def detect(self, image: np.ndarray) -> dict:
        """image: (H, W, 3) RGB uint8 -> detections in image coords."""
        return self.detect_batch([image])[0]

    def detect_batch(self, images: Sequence[np.ndarray]) -> list:
        """Batched ``detect``: one stacked forward for N frames, which may
        have different sizes (each is resized to the model input and its
        detections are rescaled back).  The dynamic-batching hook of
        ``serve.AsyncDetector``."""
        if not images:
            return []
        return self.collect_batch(self.submit_batch(images))

    def submit_batch(self, images: Sequence[np.ndarray]):
        """Streaming phase 1: preprocess and launch the forward; returns
        a handle for :meth:`collect_batch`.  Nothing waits for the card,
        so a server can launch a second batch before reading the first
        (see ``serve.AsyncDetector``)."""
        batch = self._inputs(images)
        if self._needs_calibration:
            self._calibrate(batch)
        return [np.shape(im)[:2] for im in images], self._fwd(batch)

    def collect_batch(self, handle) -> list:
        """Streaming phase 2: read back a :meth:`submit_batch` handle (one
        transfer) and rescale detections to each frame's coordinates."""
        shapes, packed = handle
        d = unpack_detections(packed.cpu().numpy())
        h, w = self.cfg.data.img_hw
        results = []
        for i, (h0, w0) in enumerate(shapes):
            v = d["valid"][i]
            boxes = d["boxes"][i][v] * np.array(
                [w0 / w, h0 / h, w0 / w, h0 / h], np.float32)
            results.append({"boxes": boxes, "scores": d["scores"][i][v],
                            "labels": d["labels"][i][v]})
        return results

    def detect_image(self, image: np.ndarray, score_thr: float = 0.3):
        """Draw detections (yolo.py detect_image analog), outlines only."""
        from glsdet_tpu_torch.utils.visualize import draw_detections

        d = self.detect(image)
        return draw_detections(image, d["boxes"], d["scores"], d["labels"],
                               self.class_names, score_thr)

    def get_fps(self, image: np.ndarray, test_interval: int = 20) -> float:
        """yolo.py:199 get_FPS analog (each ``detect`` reads its result
        back, so the time includes the card's)."""
        self.detect(image)
        t0 = time.time()
        for _ in range(test_interval):
            self.detect(image)
        return test_interval / (time.time() - t0)

    def get_map_txt(self, image_id: str, image: np.ndarray,
                    out_dir: str) -> str:
        """Write ``detection-results/<id>.txt`` (yolo.py:251)."""
        os.makedirs(out_dir, exist_ok=True)
        d = self.detect(image)
        path = os.path.join(out_dir, f"{image_id}.txt")
        with open(path, "w") as f:
            for box, score, label in zip(d["boxes"], d["scores"],
                                         d["labels"]):
                name = self.class_names[int(label)]
                f.write(f"{name} {score:.6f} {int(box[0])} {int(box[1])} "
                        f"{int(box[2])} {int(box[3])}\n")
        return path


class TwoStageDetector:
    """Two-stage UFPMP predictor facade, the serving twin of
    ``tools/ufpmp_det_eval.py``.

    coarse detector (full frame) -> UFP packing -> MP-Det on the mosaic
    -> unmap + class-wise NMS, with global-local fusion (merge_results.py
    semantics) on by default.  The same ``detect`` / ``detect_batch``
    surface as ``Detector``, and the streaming protocol
    (``submit_batch`` / ``advance_batch`` / ``collect_batch``) that
    ``serve.AsyncDetector`` pipelines.  Packing, buckets and thresholds
    come from the coarse config's ``eval`` section.

    ``quant8="static"`` serves static int8: with ``int8_scales`` (a
    saved-scales JSON path or the ``(coarse, mp)`` pair) at once, else
    after calibrating on the first batch's first 4 frames, saving the
    scales when ``int8_scales`` names a path.  ``devices=`` (a list of
    cards, in place of ``device``) serves the batches on them in turn
    (``TwoStagePipeline(devices=)``); the lazy calibration runs on the
    first, and its scales quantize every card's copy.
    """

    _needs_calibration = False

    def __init__(self, coarse_config: str,
                 coarse_checkpoint: Optional[str] = None,
                 mp_config: str = "mp_det_res50",
                 mp_checkpoint: Optional[str] = None,
                 class_names: Optional[Sequence[str]] = None,
                 score_thr: Optional[float] = None,
                 fuse_global: bool = True,
                 use_ema: bool = True,
                 max_batch: int = 8,
                 coarse_options: Optional[dict] = None,
                 mp_options: Optional[dict] = None,
                 quant8=False,
                 int8_scales=None,
                 devices=None,
                 device="cuda"):
        resolve_device(devices[0] if devices else device)

        def models():
            # float32 on the CPU: the pipeline makes its int8 copies from
            # them there and moves them to the card.  init_detector is
            # deterministic, so a second call gives the same weights for
            # the int8 copies after calibration
            c_cfg, c_model, _ = init_detector(
                coarse_config, coarse_checkpoint, use_ema, coarse_options,
                "cpu")
            m_cfg, m_model, _ = init_detector(
                mp_config, mp_checkpoint, use_ema, mp_options, "cpu")
            return c_cfg, m_cfg, c_model, m_model

        c_cfg, m_cfg, c_model, m_model = models()
        self._models = lambda: models()[2:]
        self.cfg = c_cfg
        self.mp_cfg = m_cfg
        self.class_names = list(class_names or VISDRONE_CLASSES)
        self.score_thr = (score_thr if score_thr is not None
                          else c_cfg.eval.score_thr)
        e = c_cfg.eval
        self._pipe_kwargs = dict(
            coarse_hw=tuple(c_cfg.data.img_hw),
            num_classes=c_cfg.model.num_classes,
            ufp_scale=e.ufp_scale,
            mosaic_buckets=e.mosaic_buckets,
            max_regions=e.max_regions,
            bucket_policy=e.bucket_policy,
            pack_mode=e.pack_mode,
            coarse_score_thr=e.coarse_score_thr,
            final_nms_thr=e.chip_nms_iou,
            max_batch=max_batch,
            fuse_global=fuse_global,
            fusion_nms_thr=e.fusion_nms_iou,
            device=device, devices=devices)
        self._scales_path, scales = _scales_arg(quant8, int8_scales)
        self._needs_calibration = quant8 == "static" and scales is None
        self._pipe = TwoStagePipeline(
            c_model, m_model,
            quant8=False if self._needs_calibration else quant8,
            act_scales=scales, **self._pipe_kwargs)

    @property
    def pipeline(self) -> TwoStagePipeline:
        return self._pipe

    def close(self) -> None:
        """Stop the pipeline's host packing threads."""
        self._pipe.close()

    def _calibrate(self, images: Sequence[np.ndarray]) -> None:
        scales = self._pipe.calibrate_int8(images)
        if self._scales_path:
            save_scales(self._scales_path, scales)
        self._pipe.close()
        self._pipe = TwoStagePipeline(
            *self._models(), quant8="static", act_scales=scales,
            **self._pipe_kwargs)
        self._needs_calibration = False

    def _filter(self, out: dict) -> dict:
        m = out["scores"] >= self.score_thr
        return {"boxes": out["boxes"][m], "scores": out["scores"][m],
                "labels": out["labels"][m]}

    def detect(self, image: np.ndarray) -> dict:
        """image: (H, W, 3) RGB uint8 -> two-stage detections in image
        coordinates."""
        return self.detect_batch([image])[0]

    def detect_batch(self, images: Sequence[np.ndarray]) -> list:
        """Chunk-batched two-stage inference over N frames (the
        dynamic-batching hook of ``serve.AsyncDetector``)."""
        return self.collect_batch(self.submit_batch(images))

    def submit_batch(self, images: Sequence[np.ndarray]):
        """Streaming phase 1: upload and launch the coarse stage; returns
        a pipeline batch handle."""
        frames = [np.asarray(im, np.uint8) for im in images]
        if self._needs_calibration:
            self._calibrate(frames[:4])
        return self._pipe.submit_batch(frames)

    def advance_batch(self, handle) -> None:
        """Streaming phase 2: coarse read-back, UFP packing, stage-2
        launch.  Optional (:meth:`collect_batch` runs it if skipped);
        called while a newer batch's coarse stage is queued on the card,
        it overlaps host packing with the card's work."""
        self._pipe.dispatch_mosaics(handle)

    def collect_batch(self, handle) -> list:
        """Streaming phase 3: stage-2 read-back -> per-frame detections."""
        return [self._filter(o) for o in self._pipe.collect_batch(handle)]

    def warmup(self, image_hw) -> None:
        """Run the pipeline's stages once per bucket on blank frames of
        one input shape (``TwoStagePipeline.warmup``)."""
        self._pipe.warmup(tuple(image_hw))


def load_det_txt(path: str, class_names: Sequence[str]):
    """Read a detection txt back into arrays (merge_results.py format)."""
    name_to_id = {n: i for i, n in enumerate(class_names)}
    boxes, scores, labels = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            # class names hold no spaces in these vocabularies
            name, conf, x1, y1, x2, y2 = parts[:6]
            boxes.append([float(x1), float(y1), float(x2), float(y2)])
            scores.append(float(conf))
            labels.append(name_to_id[name])
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(scores, np.float32),
            np.asarray(labels, np.int64))
