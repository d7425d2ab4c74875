"""MP-Det training loss: GFL on the proxy scores + the BoIW contrastive
loss + the Sinkhorn OT loss to the proxies, the counterpart of
``glsdet_tpu.train.mp_loss`` (reference: MPHead ``loss`` /
``loss_single``).

- ``loss_emb``: softmax over the flattened (num_classes + 1) x num_words
  dictionary, positives the anchor's own class's words, weighted by the
  label weights, / num_total_samples / num_words, x beta;
- ``loss_op``: per class, Sinkhorn transport between that class's
  positive features and its proxies (cost = normalised cosine distance,
  reg 0.1, target marginal ``proxies_prob``), averaged over classes, x
  beta.  Positives are capped at ``max_pos_per_class`` (the first ones
  in anchor order), so shapes stay fixed;
- the dictionary update runs on detached features and returns a new
  :class:`BoIWState`.

In a process group (``parallel/mesh.py``) each rank holds its slice of
the global batch.  The GFL and contrastive losses decompose: each rank's
is its share over the global counts.  The OT loss does not: each class's
first positives are the global batch's, in image order, coupled by the
Sinkhorn plan.  So the labels are gathered, the rows the loss reads
(and those the dictionary update writes) come from the ranks that own
them, and every rank computes the same loss, its gradient flowing only
into its own rows (and into the proxies on rank 0 alone): summed over
the ranks, the gradients give the loss's once.  The dictionary update
is the same on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from glsdet_tpu_torch.models.mp_head import proxy_scores
from glsdet_tpu_torch.ops.sinkhorn import sinkhorn
from glsdet_tpu_torch.ops.topk import first_k_true
from glsdet_tpu_torch.parallel import mesh
from glsdet_tpu_torch.train.boiw import BoIWState, update_dictionary
from glsdet_tpu_torch.train.gfl_loss import GFLTargets, gfl_loss


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                     embedding: torch.Tensor,
                     num_total_samples: torch.Tensor,
                     weights: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """BoIW contrastive loss: ``features`` (N, C) raw cls features,
    ``labels`` (N,) in [0, num_classes], ``embedding`` (num_classes + 1,
    num_words, C)."""
    num_slots, num_words, c = embedding.shape
    f = _unit_rows(features)
    e = _unit_rows(embedding.reshape(-1, c))
    logits = (f @ e.T).reshape(-1, num_slots, num_words)
    # cosine similarities lie in [-1, 1], so a plain exp is safe
    exp_slot = torch.exp(logits).sum(-1)                      # (N, slots)
    total = exp_slot.sum(-1)
    onehot = (labels[:, None] == torch.arange(
        num_slots, device=labels.device)).to(exp_slot.dtype)
    pos = (exp_slot * onehot).sum(1)
    # an out-of-range label gives pos = 0: the floor keeps it finite
    log_prob = torch.log(pos.clamp(min=1e-12) / total.clamp(min=1e-12))
    if weights is not None:
        log_prob = log_prob * weights
    return -log_prob.sum() / num_total_samples / num_words


def ot_proxy_loss(features: torch.Tensor, labels: torch.Tensor,
                  proxies: torch.Tensor, proxies_prob: torch.Tensor,
                  proxies_list: Sequence[int],
                  max_pos_per_class: int = 256, reg: float = 0.1,
                  num_iters: int = 100) -> torch.Tensor:
    """Sinkhorn OT loss, every class as one batched Sinkhorn over a
    (C, K, maxP) padded cost; pad columns have zero cost and zero
    marginal, so they take no mass.  ``labels`` are the global batch's;
    in a process group ``features`` are this rank's rows of it
    (module docstring)."""
    num_classes = len(proxies_list)
    dev = features.device
    if mesh.active():
        # every rank computes the whole loss: the proxies take its
        # gradient on rank 0 alone (times 1, elsewhere times 0), so the
        # group's sum counts it once.  The graph stays the same on every
        # rank: the backward's collectives (BatchNorm's sums, remat's
        # recomputed forward) must meet in the same order everywhere
        own = torch.full((), float(mesh.rank() == 0), dtype=proxies.dtype,
                         device=proxies.device)
        proxies = proxies * own + proxies.detach() * (1 - own)
    units = _unit_rows(proxies)

    def distance(f):
        return 1.0 - (_unit_rows(f) @ units.T + 1.0) / 2.0

    k = min(max_pos_per_class, labels.shape[0])
    masks = labels[None, :] == torch.arange(num_classes, device=dev)[:, None]
    idx, valid = first_k_true(masks, k)                       # (C, K)

    # each class's block of columns, zero-padded to the widest class
    rows = distance(mesh.gather_rows(features, idx))          # (C, K, P)
    max_p = max(proxies_list)
    starts = np.cumsum([0] + list(proxies_list))[:-1]
    cost = torch.stack([
        F.pad(rows[c, :, s0:s0 + n], (0, max_p - n))
        for c, (s0, n) in enumerate(zip(starts, proxies_list))])
    ut = torch.stack([F.pad(proxies_prob[s0:s0 + n], (0, max_p - n))
                      for s0, n in zip(starts, proxies_list)])

    plan = sinkhorn(cost, target_marginal=ut, reg=reg, num_iters=num_iters,
                    row_mask=valid, differentiable=True)
    per_class = (plan * cost).sum((-1, -2))
    per_class = torch.where(valid.any(-1), per_class, 0.0)
    return per_class.sum() / num_classes


class MPLossOut(NamedTuple):
    total: torch.Tensor
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    loss_dfl: torch.Tensor
    loss_emb: torch.Tensor
    loss_op: torch.Tensor
    boiw: BoIWState


def mp_loss(cls_feats: torch.Tensor, bbox_pred_logits: torch.Tensor,
            proxies: torch.Tensor, membership: torch.Tensor,
            boiw: BoIWState, generator: Optional[torch.Generator],
            targets: GFLTargets, anchor_centers: torch.Tensor,
            anchor_strides: torch.Tensor, num_classes: int,
            proxies_list: Sequence[int], reg_max: int = 16,
            gamma: float = 10.0,
            noise: Optional[torch.Tensor] = None) -> MPLossOut:
    """The full MP-Det loss over flattened levels: ``cls_feats`` (B, A, C)
    raw cls features (MPHead in training mode), ``bbox_pred_logits``
    (B, A, 4 * (reg_max + 1)) float32.  ``generator`` / ``noise`` feed
    the dictionary update (:func:`update_dictionary`; in a process group
    ``noise`` covers the global batch)."""
    b, a, c = cls_feats.shape
    feat_flat = cls_feats.reshape(-1, c).float()
    labels_flat = targets.labels.reshape(-1)
    proxies = proxies.float()

    scores = proxy_scores(feat_flat, proxies, membership, gamma)
    # MPHead divides by the raw weight sum; the tiny floor only turns
    # the no-positives 0/0 into 0
    gfl = gfl_loss(scores.reshape(b, a, num_classes), bbox_pred_logits,
                   targets, anchor_centers, anchor_strides, num_classes,
                   reg_max, avg_factor_floor=1e-6)

    loss_emb = boiw.beta * contrastive_loss(
        feat_flat, labels_flat, boiw.embedding, gfl.num_total_samples,
        weights=targets.label_weights.reshape(-1))
    labels_all = mesh.all_gather(labels_flat).reshape(-1)
    loss_op = boiw.beta * ot_proxy_loss(
        feat_flat, labels_all, proxies, boiw.proxies_prob, proxies_list)

    new_boiw = update_dictionary(boiw, generator, feat_flat.detach(),
                                 labels_all, noise=noise)
    total = gfl.total + loss_emb + loss_op
    return MPLossOut(total, gfl.loss_cls, gfl.loss_bbox, gfl.loss_dfl,
                     loss_emb, loss_op, new_boiw)
