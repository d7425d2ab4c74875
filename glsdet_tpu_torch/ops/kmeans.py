"""Cosine k-means on the device, the counterpart of
``glsdet_tpu.ops.kmeans``: Lloyd iterations over L2-normalised rows with
k-means++-style seeding, the restarts run together as one batch.  The
OT hook (``train/boiw.py: update_ot``) clusters each class's BoIW
dictionary with it, where the reference ran nltk's KMeansClusterer on
the host."""

from __future__ import annotations

from typing import Optional

import torch


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def _seed(generator: torch.Generator, data_n: torch.Tensor, k: int,
          restarts: int) -> torch.Tensor:
    """(restarts, k, d) k-means++ seeds on cosine distance."""
    n, d = data_n.shape
    rows = torch.arange(restarts, device=data_n.device)
    first = torch.randint(0, n, (restarts,), generator=generator,
                          device=data_n.device)
    centers = torch.zeros(restarts, k, d, dtype=data_n.dtype,
                          device=data_n.device)
    centers[:, 0] = data_n[first]
    filled = torch.arange(k, device=data_n.device)
    for i in range(1, k):
        sims = data_n @ centers.transpose(1, 2)               # (R, n, k)
        best = torch.where(filled < i, sims, -1.0).amax(-1)
        probs = torch.clamp(1.0 - best, min=1e-6)
        idx = torch.multinomial(probs, 1, generator=generator)[:, 0]
        centers[rows, i] = data_n[idx]
    return centers


def _lloyd_from(data_n: torch.Tensor, centers: torch.Tensor, k: int,
                num_iters: int):
    """Lloyd iterations from (R, k, d) centres; an empty cluster takes the
    row farthest from every centre."""
    centers = _normalize(centers)
    for _ in range(num_iters):
        sims = data_n @ centers.transpose(1, 2)               # (R, n, k)
        assign = sims.argmax(-1)
        onehot = (assign[..., None] == torch.arange(
            k, device=data_n.device)).to(data_n.dtype)
        counts = onehot.sum(1)                                # (R, k)
        sums = onehot.transpose(1, 2) @ data_n                # (R, k, d)
        new = torch.where(counts[..., None] > 0,
                          sums / counts.clamp(min=1.0)[..., None], centers)
        worst = sims.amax(-1).argmin(-1)                      # (R,)
        new = torch.where(counts[..., None] == 0,
                          data_n[worst][:, None, :], new)
        centers = _normalize(new)
    sims = data_n @ centers.transpose(1, 2)
    assign = sims.argmax(-1)
    inertia = (1.0 - sims.amax(-1)).sum(-1)
    return centers, assign, inertia


def cosine_kmeans(generator: Optional[torch.Generator], data: torch.Tensor,
                  k: int, num_iters: int = 20, restarts: int = 8,
                  init_centers: Optional[torch.Tensor] = None):
    """Cluster the rows of ``data`` (n, d) into ``k`` groups by cosine
    distance: (centres (k, d), assignments (n,), inertia) of the best of
    ``restarts`` seeded runs, drawn from ``generator`` (on ``data``'s
    device).  ``init_centers`` (k, d) runs one deterministic Lloyd pass
    from those centres instead (nltk's ``initial_means``)."""
    data_n = _normalize(data.float())
    if init_centers is not None:
        c, a, i = _lloyd_from(data_n, init_centers.float()[None], k,
                              num_iters)
        return c[0], a[0], i[0]
    centers, assigns, inertias = _lloyd_from(
        data_n, _seed(generator, data_n, k, restarts), k, num_iters)
    best = inertias.argmin()
    return centers[best], assigns[best], inertias[best]


def cluster_size_probs(assignments: torch.Tensor, k: int,
                       num_points: int) -> torch.Tensor:
    """Sorted cluster-occupancy probabilities, the Sinkhorn target
    marginal of the OT hook."""
    counts = (assignments[..., None] == torch.arange(
        k, device=assignments.device)).float().sum(-2)
    return torch.sort(counts / num_points, dim=-1).values
