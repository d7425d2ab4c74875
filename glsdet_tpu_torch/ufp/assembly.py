"""Region rows, the gather mosaic oracle and chip unmapping, the
counterparts of ``glsdet_tpu.ufp.assembly``.

Region rows are ``[x1, y1, w, h, new_x, new_y, factor]``: crop (w, h) at
(x1, y1) from the frame, upscale by ``factor`` and paste at (new_x,
new_y) in the mosaic; padding rows have ``factor == 0``.
"""

from __future__ import annotations

import numpy as np
import torch

from glsdet_tpu_torch.ops.boxes import pairwise_iof_min


def regions_to_array(regions, max_regions: int) -> np.ndarray:
    """Pack ``Region``s into padded (max_regions, 7) float32 rows, floored
    like the reference's mosaic assembly so chips land on whole pixels."""
    arr = np.zeros((max_regions, 7), dtype=np.float32)
    for i, r in enumerate(regions[:max_regions]):
        arr[i] = np.floor(np.asarray(r.as_row(), dtype=np.float64))
    return arr


def assemble_mosaic(image: torch.Tensor, regions: torch.Tensor,
                    out_h: int, out_w: int) -> torch.Tensor:
    """The gather oracle (cv2 crop + resize + paste semantics): every
    output pixel samples the source bilinearly at its inverse-mapped
    coordinate, clamped inside its region's crop.  (H, W, C) image,
    (R, 7) rows -> (out_h, out_w, C) float32; uncovered pixels are 0.
    Used by the tests as ground truth for the painter's chip interiors.
    """
    img = image.float()
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    yy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    src_y = torch.zeros((out_h, out_w), device=dev)
    src_x = torch.zeros((out_h, out_w), device=dev)
    covered = torch.zeros((out_h, out_w), dtype=torch.bool, device=dev)
    for x1, y1, rw, rh, nx, ny, f in regions.float().tolist():
        if f <= 0:
            continue
        inside = ((xx >= nx) & (xx < nx + rw * f)
                  & (yy >= ny) & (yy < ny + rh * f))
        # cv2 convention: src = (dst + 0.5) * (src / dst size) - 0.5
        ry = ((yy - ny + 0.5) * (1.0 / f) - 0.5).clamp(0.0, rh - 1.0) + y1
        rx = ((xx - nx + 0.5) * (1.0 / f) - 0.5).clamp(0.0, rw - 1.0) + x1
        src_y = torch.where(inside, ry, src_y)
        src_x = torch.where(inside, rx, src_x)
        covered = covered | inside
    y0 = src_y.floor().clamp(0, h - 1)
    x0 = src_x.floor().clamp(0, w - 1)
    y1i = (y0 + 1).clamp(0, h - 1).long()
    x1i = (x0 + 1).clamp(0, w - 1).long()
    wy = (src_y - y0)[..., None]
    wx = (src_x - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    top = img[y0, x0] * (1 - wx) + img[y0, x1i] * wx
    bot = img[y1i, x0] * (1 - wx) + img[y1i, x1i] * wx
    out = top * (1 - wy) + bot * wy
    return torch.where(covered[..., None], out, 0.0)


def chip_boxes_from_regions(regions: torch.Tensor) -> torch.Tensor:
    """(..., R, 7) region rows -> (..., R, 4) xyxy chips in mosaic space."""
    nx, ny = regions[..., 4], regions[..., 5]
    w, h, f = regions[..., 2], regions[..., 3], regions[..., 6]
    return torch.stack([nx, ny, nx + w * f, ny + h * f], dim=-1)


def unmap_chip_detections(det_boxes: torch.Tensor, det_valid: torch.Tensor,
                          regions: torch.Tensor,
                          iof_threshold: float = 0.9):
    """Map mosaic detections back to the frame through every chip they
    transfer through: the reference's duplicate-per-matching-chip loop
    (min-IoF > ``iof_threshold``), one output slot per (det, chip) pair.

    Args: det_boxes (..., N, 4) mosaic xyxy; det_valid (..., N) bool;
    regions (..., R, 7).  Returns boxes (..., N, R, 4) in frame
    coordinates and the (..., N, R) bool transfer mask.  The pipeline
    uses :func:`unmap_chip_detections_argmax`, which keeps the NMS at N
    candidates instead of N * R."""
    chips = chip_boxes_from_regions(regions)                  # (..., R, 4)
    live = regions[..., 6] > 0
    iof = pairwise_iof_min(det_boxes, chips)                  # (..., N, R)
    take = (iof > iof_threshold) & det_valid[..., :, None] \
        & live[..., None, :]
    f = torch.clamp(regions[..., 6], min=1.0)[..., None, :]
    ox, oy = regions[..., None, :, 0], regions[..., None, :, 1]
    nx, ny = regions[..., None, :, 4], regions[..., None, :, 5]
    bx = det_boxes[..., :, None, :]
    x1 = (bx[..., 0] - nx) / f + ox
    y1 = (bx[..., 1] - ny) / f + oy
    x2 = x1 + (bx[..., 2] - bx[..., 0]) / f
    y2 = y1 + (bx[..., 3] - bx[..., 1]) / f
    return torch.stack([x1, y1, x2, y2], dim=-1), take


def unmap_chip_detections_argmax(det_boxes: torch.Tensor,
                                 det_valid: torch.Tensor,
                                 regions: torch.Tensor,
                                 iof_threshold: float = 0.9):
    """Map mosaic detections back to the frame through their best-IoF
    chip (first maximum on ties, as ``jnp.argmax``).

    Args: det_boxes (..., N, 4) mosaic xyxy; det_valid (..., N) bool;
    regions (..., R, 7).  Returns boxes (..., N, 4) in frame coordinates
    and valid (..., N): min-IoF with the best chip > ``iof_threshold``.
    """
    chips = chip_boxes_from_regions(regions)
    live = regions[..., 6] > 0
    iof = pairwise_iof_min(det_boxes, chips)                  # (..., N, R)
    iof = torch.where(live[..., None, :], iof, -1.0)
    best = iof.argmax(dim=-1)                                 # (..., N)
    best_iof = torch.gather(iof, -1, best[..., None])[..., 0]
    valid = (best_iof > iof_threshold) & det_valid
    r = torch.gather(regions, -2,
                     best[..., None].expand(*best.shape, regions.shape[-1]))
    f = torch.clamp(r[..., 6], min=1.0)
    x1 = (det_boxes[..., 0] - r[..., 4]) / f + r[..., 0]
    y1 = (det_boxes[..., 1] - r[..., 5]) / f + r[..., 1]
    x2 = x1 + (det_boxes[..., 2] - det_boxes[..., 0]) / f
    y2 = y1 + (det_boxes[..., 3] - det_boxes[..., 1]) / f
    return torch.stack([x1, y1, x2, y2], dim=-1), valid
