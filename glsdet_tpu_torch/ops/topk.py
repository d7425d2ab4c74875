"""Small-k top-k and first-k selection with ``lax.top_k``'s tie order,
the counterparts of ``glsdet_tpu.ops.topk``.

``torch.topk`` does not promise an order among equal values, and the
training path depends on it (ATSS's per-level candidates, the BoIW
dictionary's random subset), so :func:`topk_small_k` is the JAX
package's argmax loop: ``torch.argmax`` returns the first maximum, which
gives descending values with ties by ascending index.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _lowest(dtype: torch.dtype):
    if dtype.is_floating_point:
        return torch.finfo(dtype).min
    return torch.iinfo(dtype).min


def topk_small_k(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices) of the k largest along the last axis:
    descending, ties by ascending index, as ``lax.top_k``.  k passes of
    argmax + mask; extracted entries are set to the dtype's minimum, so
    inputs must stay finite and above it."""
    n = x.shape[-1]
    if k >= n:
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k]
    iota = torch.arange(n, device=x.device)
    low = _lowest(x.dtype)
    vals, idxs = [], []
    cur = x
    for _ in range(k):
        idx = torch.argmax(cur, dim=-1)
        vals.append(torch.amax(cur, dim=-1))
        idxs.append(idx)
        cur = cur.masked_fill(iota == idx[..., None], low)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def first_k_true(mask: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first k set entries along the last axis and a
    validity mask, ``(idx (..., k) int64, valid (..., k) bool)``.

    Valid slots equal ``lax.top_k(mask.astype(f32), k)``'s indices;
    invalid slots hold an unspecified index in range and must be masked
    with ``valid``.  One cumsum and k binary searches: no sort, and no
    data-dependent shape.
    """
    n = mask.shape[-1]
    cs = torch.cumsum(mask.to(torch.int32), dim=-1)
    want = torch.arange(1, k + 1, device=mask.device, dtype=torch.int32)
    want = want.expand(*mask.shape[:-1], k).contiguous()
    idx = torch.searchsorted(cs.contiguous(), want, side="left")
    valid = torch.arange(k, device=mask.device) < cs[..., -1:]
    return idx.clamp(max=n - 1), valid
