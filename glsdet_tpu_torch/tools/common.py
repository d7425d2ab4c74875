"""What the port's command-line tools share: the multi-process flags of
the commands that run across processes and the group they join, the
device flag, the compute dtype of a model a command runs, the forward a
model command times or exports, the ``--classes`` and checkpoint
arguments, and the box forms that the result tools hand to the fusion
and the COCO evaluator."""

from __future__ import annotations

import argparse

import numpy as np
import torch


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")


def add_dist_args(ap: argparse.ArgumentParser) -> None:
    """The JAX CLIs' multi-process flags (:func:`join_group`)."""
    ap.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT",
                    help="multi-process coordinator address, rank 0's "
                         "(tools/dist_launch.py sets it; defaults from "
                         "GLSDET_COORDINATOR)")
    ap.add_argument("--dist-num-processes", type=int, default=None,
                    help="processes in the group (defaults from "
                         "GLSDET_NUM_PROCESSES / SLURM_NTASKS)")
    ap.add_argument("--dist-process-id", type=int, default=None,
                    help="this process's rank (defaults from "
                         "GLSDET_PROCESS_ID / SLURM_PROCID)")


def join_group(args) -> bool:
    """Join the process group the ``--dist-*`` flags or the environment
    configure (``parallel/mesh.py: maybe_init_distributed``) on
    ``--device``: NCCL on the rank's card, whose ``cuda`` then means that
    card, or gloo on the CPU.  Returns whether a group was joined; leave
    it with ``parallel.shutdown()``."""
    from glsdet_tpu_torch.parallel import maybe_init_distributed

    return maybe_init_distributed(args.dist_coordinator,
                                  args.dist_num_processes,
                                  args.dist_process_id, device=args.device)


def model_dtype(cfg, device: torch.device) -> torch.dtype:
    """The dtype a command computes a model in: ``cfg.model.dtype`` on
    the card (bfloat16 unless the config says float32), float32 on the
    CPU, as the facades run."""
    if device.type == "cuda" and cfg.model.dtype != "float32":
        return torch.bfloat16
    return torch.float32


class ModelForward(torch.nn.Module):
    """The function the JAX CLIs ``benchmark`` and ``export`` jit: a
    (B, H, W, 3) float32 normalized NHWC batch through the model in
    ``dtype`` to its head maps or, ``with_nms``, to the decoded
    detections (``yolox_postprocess`` for family "yolox", else
    ``gfl_postprocess``, as the JAX CLIs dispatch; at
    ``cfg.eval.max_dets``, B2 on the card)."""

    def __init__(self, net, cfg, with_nms: bool, dtype: torch.dtype):
        super().__init__()
        self.net = net
        self.family = cfg.model.family
        self.img_hw = tuple(cfg.data.img_hw)
        self.max_dets = cfg.eval.max_dets
        self.with_nms = with_nms
        self.dtype = dtype

    def forward(self, images):
        from glsdet_tpu_torch.eval.postprocess import (gfl_postprocess,
                                                       yolox_postprocess)

        out = self.net(images.permute(0, 3, 1, 2).to(self.dtype))
        if not self.with_nms:
            return out
        if self.family == "yolox":
            cls, reg, obj = out
            return yolox_postprocess(cls, reg, obj, self.img_hw,
                                     max_dets=self.max_dets)
        cls, reg = out
        return gfl_postprocess(cls, reg, self.img_hw,
                               max_dets=self.max_dets)


def class_names(spec: str) -> list:
    """``--classes``: ``visdrone``, ``uavdt`` or comma-separated names."""
    from glsdet_tpu_torch.data.uavdt import UAVDT_CLASSES
    from glsdet_tpu_torch.data.visdrone import VISDRONE_CLASSES

    return list({"visdrone": VISDRONE_CLASSES, "uavdt": UAVDT_CLASSES}.get(
        spec, spec.split(",")))


def checkpoint_arg(ckpt):
    """A checkpoint argument as ``apis.init_detector`` takes it: ``none``
    or empty is the seeded initialisation."""
    if not ckpt or ckpt == "none":
        return None
    return ckpt


def xyxy_to_xywh(boxes: np.ndarray) -> np.ndarray:
    """(n, 4) corner boxes as COCO's (x, y, w, h), in their dtype."""
    return np.concatenate([boxes[:, :2], boxes[:, 2:] - boxes[:, :2]],
                          axis=1)


def dataset_gts(dataset) -> dict:
    """A ``CocoDataset``'s ground truth as the COCO evaluator takes it:
    image id -> (xywh boxes, contiguous labels)."""
    return {rec.img_id: (xyxy_to_xywh(rec.boxes), rec.labels)
            for rec in dataset.records}


def padded_dets(boxes, scores, labels, k: int, device) -> dict:
    """The first ``k`` detections of an image (xyxy boxes) as the fusion's
    padded (k, ...) rows on ``device``: float32 boxes and scores, int32
    labels, a valid mask."""
    n = min(len(boxes), k)
    b = np.zeros((k, 4), np.float32)
    s = np.zeros((k,), np.float32)
    lab = np.zeros((k,), np.int32)
    v = np.zeros((k,), bool)
    if n:
        b[:n] = np.asarray(boxes)[:n]
        s[:n], lab[:n], v[:n] = np.asarray(scores)[:n], \
            np.asarray(labels)[:n], True
    return {key: torch.from_numpy(a).to(device)
            for key, a in (("boxes", b), ("scores", s), ("labels", lab),
                           ("valid", v))}
