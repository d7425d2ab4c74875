"""Detection losses, the counterparts of ``glsdet_tpu.losses``.

Every function returns per-element losses; callers weight them and
divide by their normaliser.  One-hot targets are comparisons against an
``arange`` rather than ``F.one_hot``, which checks its input's range on
the host and so waits for the card.

References: QFL/DFL (mmdet ``gfocal_loss.py``), GIoU and the YOLOX IoU
loss, BCE with logits, sigmoid focal loss (mmdet ``focal_loss.py``).
"""

from __future__ import annotations

import torch

from glsdet_tpu_torch.ops.boxes import giou as _aligned_giou
from glsdet_tpu_torch.ops.boxes import iou as _aligned_iou


def _one_hot(labels: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (labels[..., None] == torch.arange(n, device=labels.device)
            ).to(dtype)


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy on logits."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def quality_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       quality: torch.Tensor, num_classes: int,
                       beta: float = 2.0) -> torch.Tensor:
    """Quality focal loss: ``logits`` (N, C), ``labels`` (N,) with
    ``num_classes`` = background, ``quality`` (N,) the IoU target of
    positives.  Returns (N,) summed over classes."""
    sigma = torch.sigmoid(logits)
    loss_all = bce_with_logits(logits, torch.zeros_like(logits)) \
        * torch.pow(sigma, beta)
    pos = labels < num_classes
    onehot = _one_hot(torch.where(pos, labels, 0), num_classes,
                      logits.dtype) * pos[:, None]
    q = quality[:, None] * onehot
    loss_pos = bce_with_logits(logits, q) * torch.pow(torch.abs(q - sigma),
                                                      beta)
    return torch.where(onehot > 0, loss_pos, loss_all).sum(-1)


def distribution_focal_loss(logits: torch.Tensor,
                            target: torch.Tensor) -> torch.Tensor:
    """DFL: cross entropy against the two integer bins around the
    continuous ``target`` (N,) in [0, reg_max], linearly weighted;
    ``logits`` (N, reg_max + 1)."""
    nbins = logits.shape[-1]
    left = torch.floor(target).long().clamp(0, nbins - 2)
    right = left + 1
    wl = right.to(logits.dtype) - target
    wr = target - left.to(logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    iota = torch.arange(nbins, device=logits.device)
    w = (wl[:, None] * (iota == left[:, None])
         + wr[:, None] * (iota == right[:, None]))
    # masked, so that a -inf in an unselected bin cannot make 0 * -inf
    return -torch.where(w != 0, logp * w, 0.0).sum(-1)


def giou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - GIoU of aligned xyxy pairs -> (N,)."""
    return 1.0 - _aligned_giou(pred, target)


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             mode: str = "square", eps: float = 1e-16) -> torch.Tensor:
    """YOLOX IoU loss on aligned xyxy pairs: 1 - iou**2 (``square``),
    -log(iou) (``log``) or 1 - iou (``linear``)."""
    i = _aligned_iou(pred, target)
    if mode == "square":
        return 1.0 - i * i
    if mode == "log":
        return -torch.log(torch.clamp(i, eps, 1.0))
    return 1.0 - i


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - target)


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss; ``labels == num_classes`` is background.
    Returns (N,) summed over classes."""
    onehot = _one_hot(torch.where(labels < num_classes, labels,
                                  num_classes),
                      num_classes + 1, logits.dtype)[..., :num_classes]
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, onehot)
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    return (alpha_t * torch.pow(1 - p_t, gamma) * ce).sum(-1)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    onehot = _one_hot(labels, logits.shape[-1], logp.dtype)
    return -torch.where(onehot != 0, logp * onehot, 0.0).sum(-1)


__all__ = [
    "bce_with_logits",
    "quality_focal_loss",
    "distribution_focal_loss",
    "giou_loss",
    "iou_loss",
    "l1_loss",
    "sigmoid_focal_loss",
    "softmax_cross_entropy",
]
