from glsdet_tpu_torch.models.detectors import GFLDet, MPDet, YOLOXDetector
from glsdet_tpu_torch.models.gfl_head import GFLHead

__all__ = ["GFLDet", "GFLHead", "MPDet", "YOLOXDetector"]
