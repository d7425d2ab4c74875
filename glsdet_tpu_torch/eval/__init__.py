"""Evaluation: postprocess/NMS, COCO metrics, fusion, the two-stage
pipeline, the eval runner."""

from glsdet_tpu_torch.eval.coco_eval import (CocoEvalResult, CocoEvaluator,
                                             summarize)
from glsdet_tpu_torch.eval.fusion import (fuse_detections,
                                          fuse_detections_batch)
from glsdet_tpu_torch.eval.postprocess import (gfl_postprocess,
                                               rescale_detections,
                                               yolox_postprocess)

__all__ = [
    "CocoEvaluator",
    "CocoEvalResult",
    "summarize",
    "fuse_detections",
    "fuse_detections_batch",
    "gfl_postprocess",
    "rescale_detections",
    "yolox_postprocess",
]
