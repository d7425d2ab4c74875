"""Config -> model, the counterpart of ``glsdet_tpu.train.loop.build_model``.

The port's models are float32 modules initialised with the JAX package's
initializers from an explicit ``torch.Generator``; where they compute in
bfloat16 is the caller's choice (``TwoStagePipeline``, ``apis.Detector``,
the train step's autocast), so ``cfg.model.dtype`` selects nothing here.
``cfg.model.remat`` checkpoints MP-Det's and GFLDet's ResNet blocks and
head towers in training.
"""

from __future__ import annotations

from typing import Optional

import torch

from glsdet_tpu_torch.config import Config
from glsdet_tpu_torch.models.detectors import GFLDet, MPDet, YOLOXDetector
from glsdet_tpu_torch.models.variants.ffa_model import FFAYoloBody


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``"cuda"`` without a GPU raises
    (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but no GPU is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: expected cuda or cpu")
    return dev


def build_model(cfg: Config, device="cuda",
                generator: Optional[torch.Generator] = None
                ) -> torch.nn.Module:
    """The model ``cfg.model`` names, float32, in eval mode, on
    ``device``.  Weights come from ``generator`` (default:
    ``torch.Generator().manual_seed(0)``).  Families ``yolox`` (with its
    ``variant``), ``ffa``, ``mpdet`` and ``gfl``."""
    dev = resolve_device(device)
    m = cfg.model
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if m.family == "yolox":
        model = YOLOXDetector(m.num_classes, m.phi, m.variant,
                              generator=generator)
    elif m.family == "mpdet":
        model = MPDet(m.num_classes, m.depth, m.feat_channels,
                      proxies_list=m.proxies_list, gamma=m.gamma,
                      remat=m.remat, generator=generator)
    elif m.family == "gfl":
        model = GFLDet(m.num_classes, m.depth, m.feat_channels,
                       remat=m.remat, generator=generator)
    elif m.family == "ffa":
        model = FFAYoloBody(m.num_classes, m.phi, generator=generator)
    else:
        raise ValueError(m.family)
    return model.to(dev).eval()
