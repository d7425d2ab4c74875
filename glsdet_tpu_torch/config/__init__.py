"""Config system of the port: dataclass tree + named configs + dotted
overrides, a copy of ``glsdet_tpu.config``.

Behavioral reference: mmdet python-file configs with ``_base_``
composition and ``--cfg-options`` dict-merge overrides
(yolox-ufp/tools/train.py:56-60, configs/_base_/*).  The two public
config names of the GLSDet pipeline are kept as the API surface
(BASELINE.json): ``coarse_det`` and ``mp_det_res50``, plus the stock
yolox recipes.

The reference repo does not ship coarse_det.py / mp_det_res50.py
(SURVEY.md §0 snapshot defects); they are reconstructed here from the
README recipe (12-epoch/1x schedule for MP-Det per epoch_12.pth,
configs/_base_/schedules/schedule_1x.py) and the YOLOX 300e recipe
(configs/yolox/yolox_s_8x8_300e_coco.py).
"""

from glsdet_tpu_torch.config.core import (
    Config,
    DataConfig,
    EvalConfig,
    ModelConfig,
    TrainConfig,
    apply_overrides,
    get_config,
    list_configs,
    parse_cfg_options,
    register_config,
)

__all__ = [
    "Config",
    "DataConfig",
    "EvalConfig",
    "ModelConfig",
    "TrainConfig",
    "apply_overrides",
    "get_config",
    "list_configs",
    "parse_cfg_options",
    "register_config",
]
