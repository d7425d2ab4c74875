"""Label assignment, the counterpart of ``glsdet_tpu.assign`` (ATSS;
SimOTA is still to be ported, ROADMAP.md queue A item 12)."""

from glsdet_tpu_torch.assign.atss import AssignResult, atss_assign

__all__ = ["AssignResult", "atss_assign"]
