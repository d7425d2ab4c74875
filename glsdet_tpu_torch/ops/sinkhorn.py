"""Entropy-regularised optimal transport (Sinkhorn scaling), the
counterpart of ``glsdet_tpu.ops.sinkhorn`` (reference: MPHead's ``sink``
routine): uniform source marginal, optional target marginal,
``K = exp(-M / reg)``, alternating scaling updates.

Leading dimensions of ``cost`` are independent problems, so one call
solves every class of the OT loss at once.
"""

from __future__ import annotations

import torch


def sinkhorn(cost: torch.Tensor,
             target_marginal: torch.Tensor | None = None,
             reg: float = 0.1, num_iters: int = 100,
             stop_thr: float = 1e-8,
             row_mask: torch.Tensor | None = None,
             differentiable: bool = False) -> torch.Tensor:
    """Transport plan ``diag(alpha) K diag(beta)`` between uniform rows
    and the given columns.

    Args:
        cost: (..., N, M) cost matrices.
        target_marginal: (..., M) column marginals; uniform if None.
        row_mask: optional (..., N) bool; masked rows get no mass, so a
            caller can pad its rows to a fixed N.
        differentiable: run exactly ``num_iters`` updates and let autograd
            go through them, as the reference's loss does.  That gradient
            is not the envelope gradient (d<P*(C), C>/dC = P* + <dP*/dC,
            C>), so the plan is not detached.  Otherwise each problem
            stops updating once the mean L1 change of its row scalings
            falls below ``stop_thr`` (the JAX package's while-loop),
            without waiting on the card: the loop runs ``num_iters``
            times and converged problems keep their values.
    """
    n, m = cost.shape[-2:]
    lead = cost.shape[:-2]
    if row_mask is None:
        us = torch.full(lead + (n, 1), 1.0 / n, dtype=cost.dtype,
                        device=cost.device)
    else:
        cnt = row_mask.sum(-1, keepdim=True).clamp(min=1)
        us = (row_mask.to(cost.dtype) / cnt)[..., None]
    if target_marginal is None:
        ut = torch.full(lead + (m, 1), 1.0 / m, dtype=cost.dtype,
                        device=cost.device)
    else:
        ut = target_marginal.to(cost.dtype).reshape(lead + (m, 1))

    kmat = torch.exp(-cost / reg)
    if row_mask is not None:
        kmat = kmat * row_mask[..., None].to(cost.dtype)
    kmat_t = kmat.transpose(-1, -2)
    eps = 1e-16
    alpha = torch.ones(lead + (n, 1), dtype=cost.dtype, device=cost.device)
    beta = torch.ones(lead + (m, 1), dtype=cost.dtype, device=cost.device)

    if differentiable:
        for _ in range(num_iters):
            alpha = us / torch.clamp(kmat @ beta, min=eps)
            beta = ut / torch.clamp(kmat_t @ alpha, min=eps)
        return alpha * kmat * beta.transpose(-1, -2)

    with torch.no_grad():
        done = torch.zeros(lead + (1, 1), dtype=torch.bool,
                           device=cost.device)
        for _ in range(num_iters):
            new_alpha = us / torch.clamp(kmat @ beta, min=eps)
            new_beta = ut / torch.clamp(kmat_t @ new_alpha, min=eps)
            err = torch.abs(alpha - new_alpha).sum(-1).mean(-1)
            alpha = torch.where(done, alpha, new_alpha)
            beta = torch.where(done, beta, new_beta)
            done = done | (err < stop_thr)[..., None, None]
    return alpha * kmat * beta.transpose(-1, -2)
