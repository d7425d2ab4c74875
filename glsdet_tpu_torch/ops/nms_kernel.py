"""Wrapper of the CUDA greedy-NMS kernel (``csrc/nms.cu``).

Replaces ``glsdet_tpu/ops/pallas_nms.py: nms_pallas_sorted``.  On a CPU
tensor the wrapper computes the plain PyTorch version
(``ops/nms.py: nms_sorted_plain``); on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import collections

import torch

from glsdet_tpu_torch.native import kernels

# the reduce pass keeps ceil(K/64) <= 64 words per row: the serving
# budgets (<= 2000) and a TTA union (scales x flips x max_dets, 2400 at
# tta_detect's defaults with 4 scales) fit
MAX_K = 4096

launches = 0          # kernel launches since the last reset
# (B, K, offset, iou_threshold) of the launches since the last
# ``shapes.clear()``, the latest 1024
shapes = collections.deque(maxlen=1024)


def nms_sorted_cuda(boxes_sorted: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float, offset: float = 0.0
                    ) -> torch.Tensor:
    """Greedy NMS over score-sorted boxes.

    Args:
        boxes_sorted: (B, K, 4) float32 xyxy, descending score order.
        valid: (B, K) bool; padding rows False.
        iou_threshold: suppress j when IoU(i, j) > thr for a kept i < j.
        offset: 0.0, or 1.0 for the legacy +1 pixel-area convention.

    Returns the (B, K) bool keep mask in the sorted order.
    """
    if boxes_sorted.device.type == "cpu":
        from glsdet_tpu_torch.ops.nms import nms_sorted_plain

        return nms_sorted_plain(boxes_sorted, valid, iou_threshold, offset)
    b, k = _check(boxes_sorted, valid)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes_sorted.device)
    if b == 0 or k == 0:
        return keep
    mask = _mask_scratch(b, k, boxes_sorted.device)
    lib = kernels.load_kernels()
    stream = torch.cuda.current_stream(boxes_sorted.device).cuda_stream
    kernels.check(lib.glsdet_nms_sorted(
        boxes_sorted.data_ptr(), valid.data_ptr(), keep.data_ptr(),
        mask.data_ptr(), b, k, mask.shape[-1], float(iou_threshold),
        float(offset), stream), "glsdet_nms_sorted")
    _count(b, k, offset, iou_threshold)
    return keep


@torch.library.custom_op("glsdet_tpu_torch::nms_sorted", mutates_args=())
def nms_sorted_op(boxes_sorted: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float, offset: float) -> torch.Tensor:
    """:func:`nms_sorted_cuda` as an operator that ``torch.export`` can
    record: the wrapper hands raw pointers to a ctypes library, which no
    tracer can follow, so ``ops/nms.py: batched_nms`` calls this while a
    program is exported (``torch.compiler.is_exporting()``) and the
    wrapper itself otherwise.  A reloaded program runs the wrapper (the
    kernel on the card, counted in :data:`launches`).  An operator's
    output may not alias its input: the plain version returns ``valid``
    itself when nothing is suppressed, so that case is copied."""
    keep = nms_sorted_cuda(boxes_sorted, valid, iou_threshold, offset)
    return keep.clone() if keep is valid else keep


@nms_sorted_op.register_fake
def _nms_sorted_fake(boxes_sorted, valid, iou_threshold, offset):
    return torch.empty_like(valid)


def _count(b, k, offset, iou_threshold) -> None:
    global launches
    launches += 1
    shapes.append((b, k, float(offset), float(iou_threshold)))


def _check(boxes_sorted: torch.Tensor, valid: torch.Tensor):
    """Raises on what the kernel cannot take; returns (B, K)."""
    if boxes_sorted.dim() != 3 or boxes_sorted.shape[-1] != 4:
        raise ValueError(f"boxes: expected (B, K, 4), got "
                         f"{tuple(boxes_sorted.shape)}")
    b, k, _ = boxes_sorted.shape
    if k > MAX_K:
        raise ValueError(f"K = {k} > {MAX_K}, the NMS kernel's limit "
                         "(ops/nms_kernel.py: MAX_K)")
    if boxes_sorted.device.type != "cuda":
        raise ValueError(f"no NMS for device {boxes_sorted.device}")
    if boxes_sorted.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError("expected float32 boxes and bool valid")
    if tuple(valid.shape) != (b, k) or valid.device != boxes_sorted.device:
        raise ValueError("valid must be (B, K) on the boxes' device")
    if not (boxes_sorted.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    return b, k


def _mask_scratch(b: int, k: int, device) -> torch.Tensor:
    """Pass 1's bitmask: (B, K, stride) words, stride = ceil(K/64)
    rounded up to even so that every 64-row chunk is 16-byte aligned for
    pass 2's bulk copies."""
    nwords = (k + 63) // 64
    return torch.empty((b, k, nwords + nwords % 2), dtype=torch.int64,
                       device=device)


def nms_passes(boxes_sorted: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float, offset: float = 0.0):
    """The kernel's two passes as separate callables over buffers made
    once, for timing each alone: ``(mask_pass, reduce_pass, keep)``.
    They do not count as launches of the wrapper."""
    b, k = _check(boxes_sorted, valid)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes_sorted.device)
    mask = _mask_scratch(b, k, boxes_sorted.device)
    lib = kernels.load_kernels()

    def stream():
        return torch.cuda.current_stream(boxes_sorted.device).cuda_stream

    def mask_pass():
        kernels.check(lib.glsdet_nms_mask(
            boxes_sorted.data_ptr(), mask.data_ptr(), b, k, mask.shape[-1],
            float(iou_threshold), float(offset), stream()), "glsdet_nms_mask")

    def reduce_pass():
        kernels.check(lib.glsdet_nms_reduce(
            mask.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
            mask.shape[-1], stream()), "glsdet_nms_reduce")

    return mask_pass, reduce_pass, keep
