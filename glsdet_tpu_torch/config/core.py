"""Dataclass config tree + registry + dotted-key overrides: the port's own
copy of ``glsdet_tpu.config.core`` (pure Python; the port imports nothing
of the JAX package).  ``tests/test_torch_config.py`` holds every named
config, ``apply_overrides`` and ``parse_cfg_options`` equal to the JAX
package's.  Fields that only the JAX package's training or TPU paths read
(``model.dtype``, ``model.remat``, ``train.*``, ``data.device_color``)
are carried so that a config means the same on both sides."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple


@dataclass
class ModelConfig:
    family: str = "yolox"            # yolox | mpdet | gfl
    num_classes: int = 10
    phi: str = "s"                   # yolox width/depth preset
    depth: int = 50                  # resnet depth for mpdet/gfl
    feat_channels: int = 256
    reg_max: int = 16
    gamma: float = 10.0
    proxies_list: Tuple[int, ...] = (2, 3, 2, 5, 4, 8, 8, 4, 3, 3)
    num_words: int = 200
    dtype: str = "bfloat16"          # compute dtype
    variant: str = ""                # attention variant: ffa|lsk|cfp|...
    remat: bool = True               # checkpoint resnet blocks/head towers
                                     # in training (bandwidth-bound bwd)


@dataclass
class DataConfig:
    dataset: str = "visdrone"        # visdrone | uavdt | coco
    ann_file: str = ""
    img_root: str = ""
    val_ann_file: str = ""
    val_img_root: str = ""
    img_hw: Tuple[int, int] = (640, 640)
    max_gt: int = 300
    batch_size: int = 8
    mosaic: bool = True
    mixup: bool = True
    hsv: bool = True
    flip_prob: float = 0.5
    num_workers: int = 4
    # render the color stage (mixup blend + HSV jitter) on device inside
    # the train step (data/device_color.py) — host keeps parameter
    # sampling + exact box geometry.  Frees ~half the per-sample host
    # cost on CPU-starved hosts; pixel numerics differ from the cv2
    # path by <=2 codes on <1% of pixels (see device_color docstring).
    device_color: bool = True
    # decoded-image RAM cache (CocoDataset cache_images): mosaic decodes
    # 4 images per sample, the dominant host cost once the color stage
    # is on device.  Off by default (RAM budget is the caller's call).
    cache_images: bool = False
    cache_bytes: int = 4 << 30


@dataclass
class TrainConfig:
    epochs: int = 300
    optimizer: str = "yolox_sgd"     # yolox_sgd | mp_sgd | adam_step
    base_lr: float = 0.01
    weight_decay: float = 5e-4
    warmup_epochs: int = 5
    num_last_epochs: int = 15        # no-aug + L1 epochs (YOLOX recipe)
    min_lr_ratio: float = 0.05
    grad_clip: float = 0.0
    ema: bool = True
    seed: int = 0
    # MP-Det OT schedule (optimal_transport_hook.py)
    ot_interval: int = 2000
    ot_stop_epoch: int = 8
    emd_start_epoch: int = 2
    ckpt_interval: int = 1
    log_interval: int = 50
    # optimizer steps per group (train/loop.py). K>1 runs K steps back
    # to back with no host read between them (the reference's runner is
    # strictly one iteration at a time). Host hooks (OT update, logging)
    # fire at group boundaries, so ot_interval and log_interval must be
    # multiples of K (validated at loop start).
    steps_per_call: int = 1
    # multi-scale training (yolox family only).  Non-empty = every
    # multiscale_interval steps the train size hops to a deterministic
    # pseudo-random entry of this list (parallel/mesh.py
    # multiscale_size: a step-seeded hash every host computes
    # identically — the zero-communication replacement for the
    # reference's rank-0 NCCL size broadcast, SyncRandomSizeHook).  The
    # loader stays at data.img_hw; each size is its own compiled step
    # that resizes on device (steps.py make_yolox_train_step
    # resize_from), so expect one extra compile per size.  Sizes should
    # be 32-multiples.
    multiscale_sizes: Tuple[int, ...] = ()
    multiscale_interval: int = 10
    # bbox regression loss for the YOLOX families: 'square' is the
    # reference recipe (1 - iou^2); 'giou' is a rebuild extra whose
    # gradient attracts DISJOINT boxes — use it when training from
    # scratch without mosaic (the square mode plateaus there until the
    # last-epochs L1 phase; see train/yolox_loss.py bbox_loss_mode)
    bbox_loss_mode: str = "square"
    # iteration-based training (mmdet IterBasedRunner +
    # InfiniteGroupBatchSampler analog, samplers/infinite_sampler.py:9).
    # >0 = train for exactly this many optimizer steps on an endless
    # grouped sample stream (no epoch boundaries; epoch-cadenced hooks
    # — checkpoint/eval — fire every len(dataset)/batch_size steps).
    # LR schedules span max_iters instead of epochs*steps_per_epoch.
    max_iters: int = 0
    # two-phase frozen-backbone recipe (yolox-drone train.py:196-262:
    # Freeze_Epoch phase with Freeze_lr/Freeze_batch_size and
    # backbone.requires_grad=False, then a fresh optimizer unfrozen).
    # freeze_epochs=0 disables; 0-valued lr/batch fall back to
    # base_lr / data.batch_size.  Sections are top-level param
    # collections (optax.multi_transform set_to_zero partition).
    freeze_epochs: int = 0
    freeze_lr: float = 0.0
    freeze_batch_size: int = 0
    freeze_sections: Tuple[str, ...] = ("backbone",)
    work_dir: str = "work_dirs/default"
    resume: str = ""
    # weights-only init (mmdet load_from; shape-matched partial load).
    # ``resume`` takes precedence when both are set.
    load_from: str = ""


@dataclass
class EvalConfig:
    score_thr: float = 0.01
    nms_iou: float = 0.65
    max_dets: int = 100
    max_dets_coco: Tuple[int, ...] = (10, 100, 500)
    # two-stage
    ufp_scale: float = 1.5
    chip_nms_iou: float = 0.6
    fusion_nms_iou: float = 0.65
    coarse_score_thr: float = 0.3
    # model-canvas buckets (128-multiples; painting alignment is
    # handled separately — eval/two_stage.py: paint_hw_for)
    mosaic_buckets: Tuple[int, ...] = (768, 1024, 1152, 1280, 1536,
                                       1792, 2688)
    max_regions: int = 32
    # "image" (smallest covering bucket per image) or "chunk-max" (one
    # mosaic group per chunk at the largest needed bucket — avoids pow2
    # padding waste in chunked/staged serving)
    bucket_policy: str = "image"
    # "square" (reference layout: width binary search, bucketed after)
    # or "bucket-fit" (pack directly into the bucket ladder — smaller
    # model canvases on dense loads; layout-only change)
    pack_mode: str = "square"


@dataclass
class Config:
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)


_REGISTRY: Dict[str, Callable[[], Config]] = {}


def register_config(name: str):
    def deco(fn: Callable[[], Config]):
        _REGISTRY[name] = fn
        return fn

    return deco


def list_configs() -> List[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> Config:
    """Resolve a named config. Accepts 'coarse_det', 'coarse_det.py',
    or a path ending in one of the registered names."""
    import os

    key = os.path.basename(name)
    if key.endswith(".py"):
        key = key[:-3]
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown config '{name}'; available: {list_configs()}")
    cfg = _REGISTRY[key]()
    cfg.name = key
    return cfg


def parse_cfg_options(pairs) -> Dict[str, Any]:
    """Parse CLI ``KEY=VAL`` pairs (mmdet DictAction analog): values are
    python literals when they parse, else raw strings."""
    import ast

    out: Dict[str, Any] = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def apply_overrides(cfg: Config, options: Dict[str, Any]) -> Config:
    """mmdet --cfg-options analog: dotted keys into the dataclass tree,
    e.g. {'train.base_lr': 0.02, 'data.batch_size': 16}."""
    for dotted, value in options.items():
        parts = dotted.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise AttributeError(f"config has no field '{dotted}'")
        cur = getattr(obj, leaf)
        if cur is not None and not isinstance(value, type(cur)):
            if isinstance(cur, tuple) and isinstance(value, (list, tuple)):
                value = tuple(value)
            else:
                value = type(cur)(value)
        setattr(obj, leaf, value)
    return cfg


# ---------------------------------------------------------------------------
# Named configs (the public API surface per BASELINE.json)
# ---------------------------------------------------------------------------


@register_config("coarse_det")
def coarse_det() -> Config:
    """Stage-1 coarse detector: YOLOX-s at 640 on VisDrone full images.

    Reconstruction note: the reference's configs/UFPMP-Det/coarse_det.py is
    absent from the snapshot (SURVEY.md §0); README.md:82 trains it with
    tools/train.py and loads epoch_12.pth, i.e. a 12-epoch schedule over
    the YOLOX recipe.
    """
    cfg = Config(
        model=ModelConfig(family="yolox", phi="s", num_classes=10),
        data=DataConfig(dataset="visdrone", img_hw=(640, 640),
                        batch_size=8),
        train=TrainConfig(epochs=12, optimizer="yolox_sgd", base_lr=0.01,
                          warmup_epochs=1, num_last_epochs=2,
                          work_dir="work_dirs/coarse_det"),
        eval=EvalConfig(score_thr=0.01, nms_iou=0.65),
    )
    return cfg


@register_config("mp_det_res50")
def mp_det_res50() -> Config:
    """Stage-2 MP-Det: ResNet-50 + FPN + MPHead on UFP mosaics.

    12-epoch 1x schedule (schedule_1x.py: SGD lr 0.01, steps [8, 11]),
    OT hook every 2000 iters until epoch 8, emd/beta switch at epoch 2
    (optimal_transport_hook.py:25-38).
    """
    cfg = Config(
        model=ModelConfig(family="mpdet", depth=50, num_classes=10),
        data=DataConfig(dataset="visdrone_ufp", img_hw=(1024, 1024),
                        batch_size=4, mosaic=False, mixup=False),
        train=TrainConfig(epochs=12, optimizer="mp_sgd", base_lr=0.01,
                          weight_decay=1e-4, grad_clip=35.0,
                          num_last_epochs=0,
                          work_dir="work_dirs/mp_det_res50"),
        eval=EvalConfig(score_thr=0.01, nms_iou=0.6, max_dets=500),
    )
    return cfg


@register_config("yolox_s_300e")
def yolox_s_300e() -> Config:
    """Stock YOLOX-s 300-epoch recipe (configs/yolox/yolox_s_8x8_300e_coco.py)."""
    return Config(
        model=ModelConfig(family="yolox", phi="s", num_classes=10),
        data=DataConfig(img_hw=(640, 640), batch_size=8),
        train=TrainConfig(epochs=300, base_lr=0.01, warmup_epochs=5,
                          num_last_epochs=15,
                          work_dir="work_dirs/yolox_s_300e"),
    )


def _register_yolox_size_family():
    """Named configs for every stock YOLOX size the reference ships
    (configs/yolox/yolox_{nano,tiny,m,l,x}_8x8_300e_coco.py — each is a
    width/depth override of the s config; PHI_TABLE carries the same
    (deepen, widen, depthwise) triples, incl. nano's use_depthwise).

    The reference tiny/nano configs also narrow the multi-scale range to
    (10,20)*32 and test at 416; multi-scale stays opt-in here
    (train.multiscale_sizes) and eval size follows data.img_hw, so those
    knobs are left to --cfg-options like every other recipe detail.
    """
    for phi in ("nano", "tiny", "m", "l", "x"):
        def make(phi=phi):
            cfg = yolox_s_300e()
            cfg.model.phi = phi
            cfg.train.work_dir = f"work_dirs/yolox_{phi}_300e"
            return cfg
        register_config(f"yolox_{phi}_300e")(make)


_register_yolox_size_family()


@register_config("yolox_tiny_ufp")
def yolox_tiny_ufp() -> Config:
    """yolox-drone style UFP trainer (train_ufp.py: 640, Adam+StepLR)."""
    return Config(
        model=ModelConfig(family="yolox", phi="tiny", num_classes=10),
        data=DataConfig(img_hw=(640, 640), batch_size=8),
        train=TrainConfig(epochs=100, optimizer="adam_step",
                          base_lr=1e-3, weight_decay=5e-4,
                          work_dir="work_dirs/yolox_tiny_ufp"),
    )


@register_config("gfl_res50")
def gfl_res50() -> Config:
    """Plain GFL baseline (MP-Det ablation)."""
    return Config(
        model=ModelConfig(family="gfl", depth=50, num_classes=10),
        data=DataConfig(img_hw=(1024, 1024), batch_size=4, mosaic=False,
                        mixup=False),
        train=TrainConfig(epochs=12, optimizer="mp_sgd", base_lr=0.01,
                          weight_decay=1e-4, grad_clip=35.0,
                          num_last_epochs=0,
                          work_dir="work_dirs/gfl_res50"),
    )


@register_config("coarse_det_uavdt")
def coarse_det_uavdt() -> Config:
    """UAVDT (3-class) coarse detector — uav_eval.py / UAVDT2COCO recipe."""
    cfg = coarse_det()
    cfg.model.num_classes = 3
    cfg.data.dataset = "uavdt"
    cfg.train.work_dir = "work_dirs/coarse_det_uavdt"
    return cfg


@register_config("mp_det_res50_uavdt")
def mp_det_res50_uavdt() -> Config:
    """UAVDT MP-Det: 3 classes; proxies re-split (paper uses per-dataset
    proxy counts; UAVDT's 3 vehicle classes get [4, 4, 4])."""
    cfg = mp_det_res50()
    cfg.model.num_classes = 3
    cfg.model.proxies_list = (4, 4, 4)
    cfg.data.dataset = "uavdt_ufp"
    cfg.train.work_dir = "work_dirs/mp_det_res50_uavdt"
    return cfg


@register_config("yolox_ffa")
def yolox_ffa() -> Config:
    """FFA 4-level model (yolox-drone train.py recipe: Adam + StepLR)."""
    return Config(
        model=ModelConfig(family="ffa", phi="s", num_classes=10),
        data=DataConfig(img_hw=(640, 640), batch_size=8),
        train=TrainConfig(epochs=100, optimizer="adam_step",
                          base_lr=1e-3, weight_decay=5e-4,
                          work_dir="work_dirs/yolox_ffa"),
    )
