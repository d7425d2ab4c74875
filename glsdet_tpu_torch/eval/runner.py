"""Single-stage eval runner, the counterpart of ``glsdet_tpu.eval.runner``:
dataset -> forward + decode + NMS on the device -> COCO metrics.

Behavioral reference: ``mmdet/apis/test.py:17`` (single_gpu_test loop) +
``CocoDataset.evaluate``.  The loop streams fixed-shape letterboxed uint8
batches (``data/loader.py: EvalPipeline(raw_uint8=True)``, ``eval_loader``)
to the device, normalizes them there, runs the model and its decode +
NMS (kernel B2 on the card), reads each batch's detections back in one
transfer, undoes the letterbox on the host in numpy, and scores the set
with the numpy COCO evaluator (maxDets [10, 100, 500]).

``apply_fn`` takes the model's (B, 3, h, w) input: an ``nn.Module`` (or
any callable) as ``apply_fn(images)``, or ``apply_fn(variables, images)``
when ``variables`` is given (e.g. ``torch.func.functional_call`` over an
EMA state dict).  It returns the per-level NHWC head maps: ``(cls, reg,
obj)`` for families "yolox" and "ffa", ``(cls, reg)`` otherwise ("gfl",
which MP-Det uses too).  The input is cast to ``dtype`` (default: the
dtype of the module's first floating parameter, else float32), so a
bfloat16 model gets a bfloat16 input.

Each run's ``stats`` adds to the JAX package's keys the host time
(``host_s``: building batches, the letterbox included, and the undo) and
its share of the elapsed time (``host_share``).

``run_eval(mesh=parallel.data_mesh())`` evaluates across the processes of
a group as the JAX package's ``mesh=`` does across devices: each global
batch of ``batch_size`` is split by ``shard_batch``, each rank loads and
runs its rows (forward, decode, B2), and the fixed-shape detections are
gathered, so that every rank undoes and scores the whole set.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from glsdet_tpu_torch.data.augment import letterbox
from glsdet_tpu_torch.data.coco import (IMAGENET_MEAN, IMAGENET_STD,
                                        CocoDataset, make_batch)
from glsdet_tpu_torch.data.loader import EvalPipeline, eval_loader
from glsdet_tpu_torch.eval.coco_eval import (CocoEvalResult, CocoEvaluator,
                                             summarize)
from glsdet_tpu_torch.eval.postprocess import (gfl_postprocess,
                                               yolox_postprocess)
from glsdet_tpu_torch.eval.tta import tta_detect
from glsdet_tpu_torch.eval.two_stage import (pack_detections,
                                             unpack_detections)
from glsdet_tpu_torch.models.build import resolve_device
from glsdet_tpu_torch.parallel import mesh as pmesh

_norm: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _maybe_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 canvases -> ``(x - mean) / std`` in float32 on their device,
    dividing by a (3,) float32 tensor as the JAX package does (CUDA turns
    a division by a Python scalar into a multiplication by its
    reciprocal); float input passes through."""
    if images.dtype != torch.uint8:
        return images
    dev = images.device
    if dev not in _norm:
        _norm[dev] = (torch.from_numpy(IMAGENET_MEAN).to(dev),
                      torch.from_numpy(IMAGENET_STD).to(dev))
    mean, std = _norm[dev]
    return (images.float() - mean) / std


def _input_dtype(apply_fn, dtype) -> torch.dtype:
    if dtype is not None:
        return dtype
    if isinstance(apply_fn, torch.nn.Module):
        for p in apply_fn.parameters():
            if p.is_floating_point():
                return p.dtype
    return torch.float32


def _make_forward(apply_fn: Callable, variables, family: str, img_hw,
                  strides, score_thr: float, nms_iou: float, max_dets: int,
                  dtype: torch.dtype):
    """(B, H, W, 3) device images -> (B, max_dets, 7) packed detections
    in canvas coordinates, on the device."""
    yolox = family in ("yolox", "ffa")
    yolox_strides = strides or ((4, 8, 16, 32) if family == "ffa"
                                else (8, 16, 32))

    @torch.inference_mode()
    def forward(images: torch.Tensor) -> np.ndarray:
        x = _maybe_normalize(images).to(dtype).permute(0, 3, 1, 2)
        out = apply_fn(variables, x) if variables is not None \
            else apply_fn(x)
        if yolox:
            cls, reg, obj = out
            d = yolox_postprocess(cls, reg, obj, img_hw,
                                  strides=yolox_strides,
                                  score_thr=score_thr, iou_thr=nms_iou,
                                  max_dets=max_dets)
        else:
            cls, reg = out
            d = gfl_postprocess(cls, reg, img_hw, score_thr=score_thr,
                                iou_thr=nms_iou, max_dets=max_dets)
        return pack_detections(d["boxes"], d["scores"], d["labels"],
                               d["valid"])

    return forward


def _prepare(device, family, apply_fn, dtype):
    dev = resolve_device(device)
    if dev.type == "cuda":
        # float32 math stays float32 (the proxy-score products and the
        # decode), as in TwoStagePipeline
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev, _input_dtype(apply_fn, dtype)


def _gts(dataset: CocoDataset, dets_by_img: dict, max_images) -> dict:
    gts = {}
    for rec in dataset.records:
        if max_images is not None and rec.img_id not in dets_by_img:
            continue
        b = rec.boxes
        gts[rec.img_id] = (
            np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], axis=1),
            rec.labels)
    return gts


def _dump_json(dataset, dets_by_img: dict, out_json: str,
               verbose: bool) -> None:
    """COCO detection-results file (tools/test.py --format-only / --out):
    contiguous label -> the dataset's own COCO category id (the VisDrone
    converter writes 0-based ids, stock COCO is 1-based)."""
    cat_ids = getattr(dataset, "cat_ids", None)
    dump = []
    for img_id, (xywh, ss, ll) in dets_by_img.items():
        for box, sc, lb in zip(xywh, ss, ll):
            dump.append({
                "image_id": int(img_id),
                "category_id": (int(cat_ids[int(lb)]) if cat_ids
                                else int(lb) + 1),
                "bbox": [round(float(v), 2) for v in box],
                "score": round(float(sc), 5),
            })
    with open(out_json, "w") as f:
        json.dump(dump, f)
    if verbose:
        print(f"wrote {len(dump)} detections -> {out_json}")


def _sharded_batches(pipeline: EvalPipeline, batch_size: int,
                     mesh: "pmesh.DataMesh"):
    """``eval_loader``'s global batches (the tail padded with its last
    sample), each rank loading only its rows (``shard_batch`` of the
    batch's dataset indices)."""
    n = len(pipeline.ds)
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        idxs += idxs[-1:] * (batch_size - len(idxs))
        rows = pmesh.shard_batch({"idx": np.asarray(idxs)}, mesh)["idx"]
        yield make_batch([pipeline(int(i)) for i in rows])


_META = ("img_id", "scale", "offset", "orig_hw")


def _gathered_meta(batch: dict, dev) -> dict:
    """The global batch's undo metadata from every rank's rows, in rank
    order (float64 holds the ids and sizes exactly)."""
    cols = [np.asarray(batch[k], np.float64).reshape(len(batch["img_id"]), -1)
            for k in _META]
    local = torch.from_numpy(np.concatenate(cols, axis=1)).to(dev)
    table = pmesh.all_gather(local).flatten(0, 1).cpu().numpy()
    out, j = {}, 0
    for k, c in zip(_META, cols):
        v = table[:, j:j + c.shape[1]]
        j += c.shape[1]
        out[k] = (v.astype(np.asarray(batch[k]).dtype) if c.shape[1] > 1
                  else v[:, 0].astype(np.asarray(batch[k]).dtype))
    return out


def _timing(n_done: int, elapsed: float, host: float) -> dict:
    return {"images": n_done, "elapsed_s": round(elapsed, 2),
            "images_per_sec": round(n_done / max(elapsed, 1e-9), 2),
            "host_s": host, "host_share": host / max(elapsed, 1e-9)}


def run_eval(
    dataset: CocoDataset,
    apply_fn: Callable,
    family: str,
    img_hw: Tuple[int, int],
    num_classes: int,
    batch_size: int = 8,
    score_thr: float = 0.01,
    nms_iou: float = 0.65,
    max_dets: int = 100,
    max_images: Optional[int] = None,
    verbose: bool = True,
    variables=None,
    strides=None,
    mesh=None,
    out_json: Optional[str] = None,
    format_only: bool = False,
    show_dir: Optional[str] = None,
    show_score_thr: float = 0.3,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> Tuple[Optional[CocoEvalResult], dict]:
    """Evaluate ``apply_fn`` (module docstring) over ``dataset``; returns
    (COCO result or None with ``format_only``, stats).

    ``mesh`` (``parallel.data_mesh()``) evaluates across the processes of
    its group on its device (module docstring); any other type raises
    ``TypeError``.  ``show_dir`` draws the box outlines in numpy
    (``utils/visualize.py``) and writes PNGs with ``data/image_io.py:
    write_png``.
    """
    if mesh is not None and not isinstance(mesh, pmesh.DataMesh):
        raise TypeError(f"mesh= takes parallel.data_mesh(), not "
                        f"{type(mesh).__name__}")
    dev, dtype = _prepare(device if mesh is None else mesh.device, family,
                          apply_fn, dtype)
    forward = _make_forward(apply_fn, variables, family, img_hw, strides,
                            score_thr, nms_iou, max_dets, dtype)

    pipeline = EvalPipeline(dataset, img_hw, raw_uint8=True)
    dets_by_img: Dict[int, tuple] = {}
    seen = set()
    n_done = 0
    host = 0.0
    t0 = time.time()
    batches = (eval_loader(pipeline, batch_size) if mesh is None
               else _sharded_batches(pipeline, batch_size, mesh))
    while True:
        t = time.perf_counter()
        batch = next(batches, None)
        host += time.perf_counter() - t
        if batch is None:
            break
        packed = forward(torch.from_numpy(batch["images"]).to(dev))
        if mesh is not None:
            packed = pmesh.all_gather(packed).flatten(0, 1)
            batch = _gathered_meta(batch, dev)
        d = unpack_detections(packed.cpu().numpy())
        t = time.perf_counter()
        boxes, scores = d["boxes"], d["scores"]
        labels, valid = d["labels"], d["valid"]
        for i in range(len(batch["img_id"])):
            img_id = int(batch["img_id"][i])
            if img_id in seen:
                continue
            seen.add(img_id)
            v = valid[i]
            b = boxes[i][v]
            # undo letterbox
            dx, dy = batch["offset"][i]
            s = batch["scale"][i]
            b = (b - np.array([dx, dy, dx, dy])) / s
            h0, w0 = batch["orig_hw"][i]
            b[:, [0, 2]] = b[:, [0, 2]].clip(0, w0)
            b[:, [1, 3]] = b[:, [1, 3]].clip(0, h0)
            xywh = np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], axis=1)
            dets_by_img[img_id] = (xywh, scores[i][v], labels[i][v])
            n_done += 1
        host += time.perf_counter() - t
        if max_images is not None and n_done >= max_images:
            break
    batches.close()
    elapsed = time.time() - t0

    if show_dir:
        # tools/test.py --show-dir analog: annotated prediction dumps
        from glsdet_tpu_torch.data.image_io import write_png
        from glsdet_tpu_torch.utils.visualize import draw_detections

        os.makedirs(show_dir, exist_ok=True)
        rec_by_id = {rec.img_id: rec for rec in dataset.records}
        for img_id, (xywh, ss, ll) in dets_by_img.items():
            rec = rec_by_id[img_id]
            xyxy = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]],
                                  axis=1)
            drawn = draw_detections(
                dataset.load_image(rec), xyxy, ss, ll,
                dataset.class_names, show_score_thr)
            stem = os.path.splitext(os.path.basename(rec.file_name))[0]
            write_png(os.path.join(show_dir, f"{stem}.png"),
                      np.asarray(drawn, np.uint8))
        if verbose:
            print(f"wrote {len(dets_by_img)} annotated images -> "
                  f"{show_dir}")

    if out_json:
        _dump_json(dataset, dets_by_img, out_json, verbose)
    stats = _timing(n_done, elapsed, host)
    if format_only:
        return None, stats

    result = CocoEvaluator(num_classes).evaluate(
        _gts(dataset, dets_by_img, max_images), dets_by_img)
    if verbose:
        print(summarize(result, dataset.class_names))
        print(stats)
    return result, stats


def run_eval_tta(
    dataset: CocoDataset,
    apply_fn: Callable,
    family: str,
    img_hw: Tuple[int, int],
    num_classes: int,
    tta_scales: Tuple[float, ...] = (1.0,),
    tta_flip: bool = True,
    score_thr: float = 0.01,
    nms_iou: float = 0.65,
    max_dets: int = 100,
    max_images: Optional[int] = None,
    verbose: bool = True,
    variables=None,
    strides=None,
    out_json: Optional[str] = None,
    format_only: bool = False,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> Tuple[Optional[CocoEvalResult], dict]:
    """Multi-scale + flip TTA eval (MultiScaleFlipAug semantics,
    test_time_aug.py:11 + the aug_test merge).

    Every augmented variant is letterboxed (``data/augment.py``) to the
    same ``img_hw`` canvas, so a TTA "scale" changes how much of the
    canvas the image occupies, never the model's shapes.  Per-variant
    detections are mapped back to original coordinates and fused with
    one NMS (``eval/tta.py: tta_detect``).
    """
    dev, dtype = _prepare(device, family, apply_fn, dtype)
    forward = _make_forward(apply_fn, variables, family, img_hw, strides,
                            score_thr, nms_iou, max_dets, dtype)
    host = [0.0]

    def detect_one(image: np.ndarray) -> dict:
        t = time.perf_counter()
        canvas, _, s, (dx, dy) = letterbox(
            image, np.zeros((0, 4), np.float32), img_hw)
        x = torch.from_numpy(np.ascontiguousarray(canvas, np.uint8))[None]
        host[0] += time.perf_counter() - t
        d = unpack_detections(forward(x.to(dev)).cpu().numpy())
        t = time.perf_counter()
        v = d["valid"][0]
        b = d["boxes"][0][v]
        b = (b - np.array([dx, dy, dx, dy])) / s
        h0, w0 = image.shape[:2]
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, w0)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, h0)
        out = {"boxes": b, "scores": d["scores"][0][v],
               "labels": d["labels"][0][v]}
        host[0] += time.perf_counter() - t
        return out

    dets_by_img: Dict[int, tuple] = {}
    t0 = time.time()
    for rec in dataset.records:
        if max_images is not None and len(dets_by_img) >= max_images:
            break
        t = time.perf_counter()
        img = dataset.load_image(rec)
        host[0] += time.perf_counter() - t
        d = tta_detect(detect_one, img, scales=tuple(tta_scales),
                       flip=tta_flip, iou_thr=nms_iou, max_dets=max_dets,
                       device=dev)
        b = d["boxes"]
        xywh = np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], axis=1)
        dets_by_img[rec.img_id] = (xywh, d["scores"], d["labels"])
    elapsed = time.time() - t0
    n_done = len(dets_by_img)

    if out_json:
        _dump_json(dataset, dets_by_img, out_json, verbose)
    stats = {**_timing(n_done, elapsed, host[0]),
             "tta_scales": list(tta_scales), "tta_flip": tta_flip}
    if format_only:
        return None, stats

    result = CocoEvaluator(num_classes).evaluate(
        _gts(dataset, dets_by_img, max_images), dets_by_img)
    if verbose:
        print(summarize(result, dataset.class_names))
        print(stats)
    return result, stats
