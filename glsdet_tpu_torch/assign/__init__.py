"""Label assignment, the counterpart of ``glsdet_tpu.assign``: ATSS
(MP-Det, GFL) and SimOTA (YOLOX)."""

from glsdet_tpu_torch.assign.atss import AssignResult, atss_assign
from glsdet_tpu_torch.assign.sim_ota import OTAResult, sim_ota_assign

__all__ = ["AssignResult", "atss_assign", "OTAResult", "sim_ota_assign"]
