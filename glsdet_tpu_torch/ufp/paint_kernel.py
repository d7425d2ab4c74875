"""The UFP mosaic painter: CUDA kernel wrappers (``csrc/paint.cu``) and
their plain PyTorch versions.

Replaces ``glsdet_tpu/ufp/pallas_paint.py: assemble_mosaic_pallas_batch``.
Canvas pixel (X, Y) of slot s is painted by the last region row of
``rows[s]`` whose scaled chip covers it, sampled from frame ``idx[s]``
with cv2 INTER_LINEAR taps (``src = (dst + 0.5) / f - 0.5``) that read
the real neighbouring source pixels and 0 beyond the frame border; every
other pixel is 0.  Tap weights are all k/8, so the float32 canvas is
exact and the kernel equals the plain version bit for bit.

Two entries share the kernel body:

- :func:`assemble_mosaic_cuda_batch`, the Pallas kernel's own function:
  the (b, out_h, out_w, 3) canvas in bfloat16 or float32;
- :func:`paint_mosaic_inputs_cuda`, the serving path's: MP-Det's
  normalized (b, hw, hw, 3) bfloat16 input, painted at ``hw`` and
  normalized in the same pass (plain version:
  ``eval/preprocess.py: mosaic_inputs_plain``).

On a CUDA tensor each entry launches on the frames' card (inputs on two
cards raise ``ValueError``) and reports to ``ops/cost.py``'s active
counter the bytes its bound counts: the output written once, the region
rows and the source pixels under the crops read once.

Unlike the Pallas kernel, the CUDA kernel needs no per-tile tables: each
block keeps the region rows that meet its band of canvas rows in shared
memory, without a cap, so there is no table overflow and no fallback
painter.  ``build_tile_tables`` and ``tile_max_count`` are the JAX
package's table binning, carried over and pinned by
tests/test_torch_paint.py.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from glsdet_tpu_torch.native import kernels
from glsdet_tpu_torch.ops import cost

MAX_ROWS = 1024       # region rows per slot (csrc/paint.cu: kMaxRows)
MAX_WIDTH = 8192      # canvas width (csrc/paint.cu: kMaxWidth)

launches = 0          # kernel launches since the last reset, both entries
inputs_launches = 0   # of them, the path entry's
launches_by_device = collections.Counter()   # both entries', per card


def _axis_taps(d: torch.Tensor, f: torch.Tensor):
    """Along one axis: first source tap (offset from the crop origin) and
    the two tap weights of cv2 INTER_LINEAR at local coordinate d."""
    q = torch.div(d, f, rounding_mode="floor")
    frac = ((d - q * f).float() + 0.5) / f.float() - 0.5
    neg = frac < 0
    t0 = torch.where(neg, q - 1, q)
    w0 = torch.where(neg, -frac, 1.0 - frac)
    w1 = torch.where(neg, 1.0 + frac, frac)
    return t0, w0, w1


def assemble_mosaic_plain_batch(images: torch.Tensor, idx: torch.Tensor,
                                rows: torch.Tensor, out_h: int, out_w: int,
                                dtype: torch.dtype = torch.bfloat16
                                ) -> torch.Tensor:
    """Plain PyTorch painter.  images (N, H, W, 3) uint8; idx (b,) int64
    frame of each slot; rows (b, R, 7) float32 integer-valued region
    rows.  Returns the (b, out_h, out_w, 3) ``dtype`` canvas."""
    dev = images.device
    b, n_rows = rows.shape[0], rows.shape[1]
    src_h, src_w = images.shape[1], images.shape[2]
    if n_rows == 0:                    # nothing to gather from
        return torch.zeros((b, out_h, out_w, 3), dtype=dtype, device=dev)
    r = rows.to(torch.int32)           # truncation, as the kernel's casts
    x1, y1, w, h, nx, ny, f = r.unbind(-1)
    yy = torch.arange(out_h, dtype=torch.int32, device=dev)
    xx = torch.arange(out_w, dtype=torch.int32, device=dev)
    owner = torch.full((b, out_h, out_w), -1, dtype=torch.int64, device=dev)
    for k in range(n_rows):
        live = (f[:, k] > 0) & (w[:, k] > 0) & (h[:, k] > 0)
        iny = ((yy >= ny[:, k, None]) & (yy < (ny + h * f)[:, k, None])
               & live[:, None])
        inx = (xx >= nx[:, k, None]) & (xx < (nx + w * f)[:, k, None])
        owner = torch.where(iny[:, :, None] & inx[:, None, :], k, owner)
    covered = owner >= 0
    sel = owner.clamp(min=0).reshape(b, -1)

    def per_pixel(col):                # (b, R) -> (b, out_h, out_w)
        return torch.gather(col, 1, sel).reshape(b, out_h, out_w)

    fp = per_pixel(f).clamp(min=1)
    ty, wy0, wy1 = _axis_taps(yy[:, None] - per_pixel(ny), fp)
    tx, wx0, wx1 = _axis_taps(xx[None, :] - per_pixel(nx), fp)
    sy0 = per_pixel(y1) + ty
    sx0 = per_pixel(x1) + tx
    frames = images[idx].reshape(b, src_h * src_w, 3)

    def tap(sy, sx):                   # (b, out_h, out_w, 3), 0 off-frame
        inside = (sy >= 0) & (sy < src_h) & (sx >= 0) & (sx < src_w)
        flat = (sy.clamp(0, src_h - 1) * src_w
                + sx.clamp(0, src_w - 1)).long().reshape(b, -1, 1)
        px = torch.gather(frames, 1, flat.expand(-1, -1, 3)).float()
        return torch.where(inside[..., None],
                           px.reshape(b, out_h, out_w, 3), 0.0)

    wx0, wx1 = wx0[..., None], wx1[..., None]
    top = wx0 * tap(sy0, sx0) + wx1 * tap(sy0, sx0 + 1)
    bot = wx0 * tap(sy0 + 1, sx0) + wx1 * tap(sy0 + 1, sx0 + 1)
    out = wy0[..., None] * top + wy1[..., None] * bot
    return torch.where(covered[..., None], out, 0.0).to(dtype)


def _check(images: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
           out_w: int) -> int:
    """Raises on what the kernel cannot take; returns the batch b."""
    if out_w > MAX_WIDTH:
        raise ValueError(f"canvas width {out_w} > {MAX_WIDTH}")
    if images.device.type != "cuda":
        raise ValueError(f"no painter for device {images.device}")
    if images.dtype != torch.uint8 or images.dim() != 4 \
            or images.shape[-1] != 3:
        raise ValueError("images: expected (N, H, W, 3) uint8")
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise ValueError("idx: expected (b,) int64")
    b = idx.shape[0]
    if rows.dtype != torch.float32 or rows.dim() != 3 \
            or rows.shape[0] != b or rows.shape[2] != 7:
        raise ValueError("rows: expected (b, R, 7) float32")
    if rows.shape[1] > MAX_ROWS:
        raise ValueError(f"{rows.shape[1]} region rows > {MAX_ROWS}")
    if not all(t.device == images.device for t in (idx, rows)):
        raise ValueError(f"images on {images.device}, idx on {idx.device}, "
                         f"rows on {rows.device}: inputs must share a card")
    if not all(t.is_contiguous() for t in (images, idx, rows)):
        raise ValueError("images, idx and rows must be contiguous")
    return b


def _report(images: torch.Tensor, rows: torch.Tensor,
            out: torch.Tensor) -> None:
    """The launch's bytes for an active cost counter: ``out`` written, the
    rows and the source pixels under the crops (clipped to the frame)
    read.  Reads the rows back, so only while counting."""
    counter = cost.current()
    if counter is None:
        return
    with counter.paused():
        r = rows.to(torch.int64)
        src = int((r[..., 2].clamp(0, images.shape[2])
                   * r[..., 3].clamp(0, images.shape[1])).sum()) * 3
    cost.report(cost.tensor_bytes(out) + cost.tensor_bytes(rows) + src)


def assemble_mosaic_cuda_batch(images: torch.Tensor, idx: torch.Tensor,
                               rows: torch.Tensor, out_h: int, out_w: int,
                               dtype: torch.dtype = torch.bfloat16
                               ) -> torch.Tensor:
    """Paint (b, out_h, out_w, 3) canvases; arguments as
    :func:`assemble_mosaic_plain_batch`.  On the CPU this is the plain
    version; on a CUDA tensor it launches the kernel or raises."""
    global launches
    if images.device.type == "cpu":
        return assemble_mosaic_plain_batch(images, idx, rows, out_h, out_w,
                                           dtype)
    b = _check(images, idx, rows, out_w)
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"canvas dtype {dtype}: bfloat16 or float32")
    out = torch.empty((b, out_h, out_w, 3), dtype=dtype,
                      device=images.device)
    if b == 0 or out_h == 0 or out_w == 0:
        return out
    lib = kernels.load_kernels()
    n_src, src_h, src_w = images.shape[:3]
    with torch.cuda.device(images.device):
        kernels.check(lib.glsdet_paint_mosaic(
            images.data_ptr(), n_src, src_h, src_w, idx.data_ptr(),
            rows.data_ptr(), b, rows.shape[1], out.data_ptr(), out_h, out_w,
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream), "glsdet_paint_mosaic")
    launches += 1
    launches_by_device[images.device.index] += 1
    _report(images, rows, out)
    return out


def paint_mosaic_inputs_cuda(images: torch.Tensor, idx: torch.Tensor,
                             rows: torch.Tensor, hw: int, mean: torch.Tensor,
                             inv_std: torch.Tensor) -> torch.Tensor:
    """MP-Det's normalized input: the (b, hw, hw, 3) canvas, per channel
    ``(canvas - mean) * inv_std`` in the dtype of ``mean`` (3,) and
    ``inv_std`` (3,), each op rounding once.  Uncovered pixels hold the
    normalized 0.  Other arguments as :func:`assemble_mosaic_plain_batch`.

    On the CPU this is ``eval/preprocess.py: mosaic_inputs_plain`` (which
    paints at the JAX package's aligned canvas and crops: the same
    values).  On a CUDA tensor it launches the kernel once, painting at
    ``hw``, or raises; the card serves bfloat16 only."""
    global launches, inputs_launches
    if images.device.type == "cpu":
        from glsdet_tpu_torch.eval.preprocess import mosaic_inputs_plain

        return mosaic_inputs_plain(images, idx, rows, hw, mean.dtype, mean,
                                   inv_std)
    b = _check(images, idx, rows, hw)
    for name, t in (("mean", mean), ("inv_std", inv_std)):
        if t.device != images.device:
            raise ValueError(f"{name} on {t.device}, images on "
                             f"{images.device}: inputs must share a card")
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (3,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous (3,) bfloat16 "
                             "tensor on the images' device")
    out = torch.empty((b, hw, hw, 3), dtype=torch.bfloat16,
                      device=images.device)
    if b == 0 or hw == 0:
        return out
    lib = kernels.load_kernels()
    n_src, src_h, src_w = images.shape[:3]
    with torch.cuda.device(images.device):
        kernels.check(lib.glsdet_paint_mosaic_inputs(
            images.data_ptr(), n_src, src_h, src_w, idx.data_ptr(),
            rows.data_ptr(), b, rows.shape[1], mean.data_ptr(),
            inv_std.data_ptr(), out.data_ptr(), hw,
            torch.cuda.current_stream().cuda_stream),
            "glsdet_paint_mosaic_inputs")
    launches += 1
    inputs_launches += 1
    launches_by_device[images.device.index] += 1
    _report(images, rows, out)
    return out


def build_tile_tables(rows: torch.Tensor, out_h: int, out_w: int,
                      tile: int, cap: int) -> torch.Tensor:
    """Device-side binning of (B, R, >=7) region rows into per-canvas-tile
    tables (B, out_h/tile, out_w/tile, cap, 8) int32 with entries
    ``[x1, y1, w, h, nx, ny, f, 1]`` in row order; entries beyond ``cap``
    are dropped (``glsdet_tpu.ufp.pallas_paint.build_tile_tables_jax``)."""
    nty, ntx = out_h // tile, out_w // tile
    bsz, n_rows = rows.shape[0], rows.shape[1]
    dev = rows.device
    r = rows[..., :7].to(torch.int32)
    w, h, nx, ny, f = r[..., 2], r[..., 3], r[..., 4], r[..., 5], r[..., 6]
    valid = (f > 0) & (w > 0) & (h > 0)
    i0 = torch.div(ny, tile, rounding_mode="floor").clamp(min=0)
    j0 = torch.div(nx, tile, rounding_mode="floor").clamp(min=0)
    i1 = torch.div(ny + h * f - 1, tile, rounding_mode="floor").clamp(
        max=nty - 1)
    j1 = torch.div(nx + w * f - 1, tile, rounding_mode="floor").clamp(
        max=ntx - 1)
    ti = torch.arange(nty, device=dev)
    tj = torch.arange(ntx, device=dev)
    mi = (ti >= i0[..., None]) & (ti <= i1[..., None])        # (B, R, nty)
    mj = (tj >= j0[..., None]) & (tj <= j1[..., None])        # (B, R, ntx)
    member = (valid[..., None, None] & mi[..., :, None]
              & mj[..., None, :]).reshape(bsz, n_rows, nty * ntx)
    slot = member.to(torch.int32).cumsum(dim=1) - 1
    n_cells = nty * ntx * cap
    tile_idx = torch.arange(nty * ntx, device=dev)
    # each (tile, slot) cell receives at most one row; everything else
    # goes to a spill cell that is cut off below
    dest = torch.where(member & (slot < cap), tile_idx * cap + slot, n_cells)
    vals = torch.cat([r, torch.ones_like(r[..., :1])], dim=-1)  # (B, R, 8)
    vals = vals[:, :, None, :].expand(-1, -1, nty * ntx, -1)
    table = torch.zeros((bsz, n_cells + 1, 8), dtype=torch.int32, device=dev)
    table.scatter_(1, dest.reshape(bsz, -1, 1).expand(-1, -1, 8),
                   vals.reshape(bsz, -1, 8))
    return table[:, :n_cells].reshape(bsz, nty, ntx, cap, 8)


def tile_max_count(rows: np.ndarray, out_h: int, out_w: int,
                   tile: int) -> int:
    """Max number of region rows touching one canvas tile (host numpy,
    ``glsdet_tpu.ufp.pallas_paint.tile_max_count``)."""
    nty, ntx = out_h // tile, out_w // tile
    r = np.asarray(rows, np.float64)[:, :7].astype(np.int64)
    r = r[(r[:, 6] > 0) & (r[:, 2] > 0) & (r[:, 3] > 0)]
    if not len(r):
        return 0
    i0 = np.maximum(r[:, 5] // tile, 0)
    j0 = np.maximum(r[:, 4] // tile, 0)
    i1 = np.minimum((r[:, 5] + r[:, 3] * r[:, 6] - 1) // tile, nty - 1)
    j1 = np.minimum((r[:, 4] + r[:, 2] * r[:, 6] - 1) // tile, ntx - 1)
    ok = (i1 >= i0) & (j1 >= j0)
    i0, j0, i1, j1 = i0[ok], j0[ok], i1[ok], j1[ok]
    d = np.zeros((nty + 1, ntx + 1), np.int64)
    np.add.at(d, (i0, j0), 1)
    np.add.at(d, (i0, j1 + 1), -1)
    np.add.at(d, (i1 + 1, j0), -1)
    np.add.at(d, (i1 + 1, j1 + 1), 1)
    return int(d.cumsum(axis=0).cumsum(axis=1)[:nty, :ntx].max())
