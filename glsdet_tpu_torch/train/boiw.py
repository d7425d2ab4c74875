"""The BoIW (bag of instance words) dictionary as training state, the
counterpart of ``glsdet_tpu.train.boiw`` (reference: MPHead's buffers,
``_update_dictionary`` and ``update_ot``).

The dictionary is an explicit value threaded through the train step:
each function returns a new :class:`BoIWState` of tensors on the state's
device and never mutates its input.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from glsdet_tpu_torch.ops.kmeans import cluster_size_probs, cosine_kmeans
from glsdet_tpu_torch.ops.topk import topk_small_k
from glsdet_tpu_torch.parallel import mesh


class BoIWState(NamedTuple):
    embedding: torch.Tensor     # (num_classes + 1, num_words, C)
    ptr: torch.Tensor           # (num_classes + 1,) int64 ring pointers
    proxies_prob: torch.Tensor  # (P,) Sinkhorn target marginals
    beta: torch.Tensor          # () float: 0 until emd training, then 1


def init_boiw(generator: torch.Generator, num_classes: int,
              num_words: int, feat_channels: int,
              proxies_list: Sequence[int], device="cuda") -> BoIWState:
    """A standard-normal dictionary drawn from ``generator`` (on
    ``device``), zero pointers, uniform marginals per class, beta 0."""
    emb = torch.randn(num_classes + 1, num_words, feat_channels,
                      generator=generator, device=device)
    prob = torch.cat([torch.full((n,), 1.0 / n, device=device)
                      for n in proxies_list])
    return BoIWState(
        embedding=emb,
        ptr=torch.zeros(num_classes + 1, dtype=torch.int64, device=device),
        proxies_prob=prob,
        beta=torch.zeros((), device=device))


def update_dictionary(state: BoIWState, generator: Optional[torch.Generator],
                      features: torch.Tensor, labels: torch.Tensor,
                      max_step: int = 10,
                      noise: Optional[torch.Tensor] = None) -> BoIWState:
    """Ring-buffer write of up to ``max_step`` random features per class.

    ``features`` (N, C), ``labels`` (N,) in [0, num_classes] (num_classes
    = background).  The random subset is the top ``max_step`` of
    ``noise + 10 * mask`` per class, with ``noise`` (num_slots, N)
    uniform: drawn from ``generator``, or given (a test feeds the JAX
    package's draw).  Fixed shapes: ranks past a class's count write to a
    spare slot that is dropped.

    In a process group (``parallel/mesh.py``) ``labels`` are the global
    batch's and ``features`` this rank's rows of it: the rows written
    come from the ranks that own them, and with the same generator state
    on every rank the update is the same everywhere.
    """
    num_slots, num_words, _ = state.embedding.shape
    n = labels.shape[0]
    max_step = min(max_step, n)
    dev = features.device
    masks = labels[None, :] == torch.arange(num_slots, device=dev)[:, None]
    step = masks.sum(1).clamp(max=max_step)                   # (S,)
    if noise is None:
        noise = torch.rand(num_slots, n, generator=generator, device=dev)
    _, idx = topk_small_k(noise + masks.float() * 10.0, max_step)
    ranks = torch.arange(max_step, device=dev)[None, :]
    slots = (state.ptr[:, None] + ranks) % num_words
    slots = torch.where(ranks < step[:, None], slots, num_words)
    rows = torch.arange(num_slots, device=dev)[:, None].expand(-1, max_step)
    spare = state.embedding.new_zeros(num_slots, 1,
                                      state.embedding.shape[-1])
    emb = torch.cat([state.embedding, spare], dim=1)
    emb[rows, slots] = mesh.gather_rows(features, idx).to(emb.dtype)
    return state._replace(embedding=emb[:, :num_words],
                          ptr=(state.ptr + step) % num_words)


def update_ot(state: BoIWState, generator: Optional[torch.Generator],
              proxies_list: Sequence[int], kmeans_iters: int = 20,
              restarts: int = 8) -> BoIWState:
    """Re-estimate the per-proxy Sinkhorn marginals: for each foreground
    class, cosine k-means (k = its proxy count) over its dictionary, and
    the sorted cluster-size histogram."""
    num_words = state.embedding.shape[1]
    probs = []
    for cls_id, k in enumerate(proxies_list):
        _, assign, _ = cosine_kmeans(generator, state.embedding[cls_id], k,
                                     num_iters=kmeans_iters,
                                     restarts=restarts)
        probs.append(cluster_size_probs(assign, k, num_words))
    return state._replace(proxies_prob=torch.cat(probs))


def enable_emd_training(state: BoIWState) -> BoIWState:
    """The OT hook's switch at ``emd_start_epoch``: beta 0 -> 1."""
    return state._replace(beta=torch.ones_like(state.beta))
