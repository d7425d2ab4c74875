"""Shared helpers of the ``test_torch_tools_*`` tests: the JAX package's
CLIs (``tools/<name>.py``) run in this process with ``sys.argv`` set,
beside the port's ``glsdet_tpu_torch.tools.<name>.main(argv)``; a seeded
frame set with ground truth and ignore regions; a seeded scrolling clip
and OpenCV's video writer and reader of it; and a JAX ``TrainState``
of seeded weights written by the JAX package's ``save_checkpoint``
(orbax), which both packages' CLIs read."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import cv2
import jax
import numpy as np
import pytest

from glsdet_tpu_torch.data.image_io import write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_ERROR)
CAT_IDS = [2 * i + 1 for i in range(10)]

# the test configs: YOLOX-nano at 64x64 and MP-Det depth 18 at 128x128,
# float32 (the JAX default computes in bfloat16)
COARSE_CLI = ["model.phi=nano", "model.dtype=float32", "data.img_hw=(64,64)",
              "data.batch_size=2", "eval.coarse_score_thr=0.0001",
              "eval.mosaic_buckets=(128,256)"]
MP_CLI = ["model.depth=18", "model.dtype=float32", "data.img_hw=(128,128)",
          "data.batch_size=2"]


def jax_cli(name: str):
    """The JAX package's ``tools/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name: str, argv, **patches):
    """Run ``tools/<name>.py``'s ``main`` with ``sys.argv`` set to
    ``argv``; ``patches`` maps "module:attribute" to the value it holds
    meanwhile.  Returns what ``main`` returns."""
    mod = jax_cli(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [f"{name}.py", *map(str, argv)])
        for target, value in patches.items():
            modname, attr = target.split(":")
            mp.setattr(sys.modules[modname], attr, value)
        return mod.main()


def frame(seed: int, hw) -> np.ndarray:
    """A smooth field with flat rectangles (the eval runner tests'
    frames)."""
    h, w = hw
    rs = np.random.RandomState(seed)
    img = np.kron(rs.randint(40, 216, (h // 8 + 1, w // 8 + 1, 3)),
                  np.ones((8, 8, 1)))[:h, :w]
    for _ in range(6):
        bh, bw = rs.randint(6, min(30, h - 1), 2)
        y, x = rs.randint(0, h - bh), rs.randint(0, w - bw)
        img[y:y + bh, x:x + bw] = rs.randint(0, 256, 3)
    return img.astype(np.uint8)


def scrolling_clip(h: int, w: int, n: int, seed: int = 0):
    """``n`` RGB frames of a smooth seeded field scrolling 2 px right and
    1.5 px down a frame under a flat band (a sky), with a red block
    moving down it: P-VOPs carry motion and skip the band, which the
    port's encoder quantises finer.  numpy only (``chip_smoke.py`` makes
    the same clip)."""
    rs = np.random.RandomState(seed)
    fh, fw = h + 2 * n + 16, w + 2 * n + 16
    coarse = rs.randint(30, 226, (fh // 8 + 2, fw // 8 + 2, 3))
    field = np.kron(coarse, np.ones((8, 8, 1))).astype(np.float64)
    c = np.pad(field, ((1, 0), (1, 0), (0, 0))).cumsum(0).cumsum(1)
    k = 9
    field = (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / k ** 2
    out = []
    for t in range(n):
        f = field[3 * t // 2:3 * t // 2 + h, 2 * t:2 * t + w].copy()
        f[:h // 4] = (150, 170, 200)
        f[8 + t:24 + t, 12:40] = (240, 30, 40)
        out.append(np.clip(f + 0.5, 0, 255).astype(np.uint8))
    return out


def cv2_write(path, frames, fps, fourcc="mp4v"):
    """RGB ``frames`` through ``cv2.VideoWriter`` (BGR, as OpenCV takes
    them)."""
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()


def cv2_read(path):
    """(RGB frames, luma planes, fps, frame count, (width, height))."""
    cap = cv2.VideoCapture(path)
    meta = (cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))))
    rgb = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        rgb.append(f[..., ::-1])
    cap.release()
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    luma = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        luma.append(f.reshape(meta[2][1], meta[2][0]))
    cap.release()
    return (rgb, luma, *meta)


def write_set(root: str, frames, gts=None, ignore=None,
              name: str = "ann.json"):
    """``frames`` (a list of (h, w)) as PNGs under ``root/img`` and a
    COCO json: ``gts`` maps frame index -> [(xywh, contiguous label)],
    ``ignore`` frame index -> [xywh] ignore regions.  Image ids are 100 +
    index, category ids ``CAT_IDS``.  Returns (json path, image root)."""
    img_root = os.path.join(root, "img")
    os.makedirs(img_root, exist_ok=True)
    images, anns, igs = [], [], []
    for i, (h, w) in enumerate(frames):
        path = os.path.join(img_root, f"{i}.png")
        if not os.path.exists(path):
            write_png(path, frame(i, (h, w)))
        images.append({"id": 100 + i, "file_name": f"{i}.png", "width": w,
                       "height": h})
        for box, lab in (gts or {}).get(i, []):
            anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                         "category_id": CAT_IDS[lab],
                         "bbox": [float(v) for v in box], "iscrowd": 0,
                         "area": float(box[2] * box[3])})
        for box in (ignore or {}).get(i, []):
            igs.append({"image_id": 100 + i,
                        "bbox": [float(v) for v in box]})
    ann = os.path.join(root, name)
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "ignore_regions": igs,
                   "categories": [{"id": c, "name": f"c{c}"}
                                  for c in CAT_IDS]}, f)
    return ann, img_root


def gts_from_dump(path: str, seed: int, per_image: int = 40):
    """Ground truth from a COCO results file: each image's detections of
    at least 2 px, every third dropped, the rest jittered by up to 2
    pixels; frame index -> [(xywh, contiguous label)]."""
    with open(path) as f:
        dump = json.load(f)
    rs = np.random.RandomState(seed)
    out = {}
    for d in dump:
        if min(d["bbox"][2:]) >= 2:
            out.setdefault(d["image_id"] - 100, []).append(d)
    gts = {}
    for i, dets in out.items():
        keep = [d for j, d in enumerate(dets) if j % 3 != 2][:per_image]
        gts[i] = [(np.maximum(np.asarray(d["bbox"]) + rs.uniform(-2, 2, 4),
                              [0, 0, 1, 1]),
                   CAT_IDS.index(d["category_id"])) for d in keep]
    return gts


def variable_shapes(model, x_shape):
    """The structure of ``model.init``'s variables at an input of
    ``x_shape``, traced without compiling (``jax.eval_shape``)."""
    import jax.numpy as jnp

    return jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                          jax.random.PRNGKey(0),
                          jnp.zeros(x_shape, jnp.float32))


def seeded_variables(model, hw, seed: int) -> dict:
    """Seeded weights of the flax ``model`` in its variables' structure,
    drawn in numpy: each kernel N(0, 1/fan_in), norm scales 1 + 0.1 N(0,
    1), biases and means 0.1 N(0, 1), variances 0.5 + U[0, 1), other
    leaves 0.1 N(0, 1).  The JAX package's jitted ``init`` would take ~17
    s to compile for a YOLOX-nano on this CPU; this takes its trace (~2
    s)."""
    rs = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1])) or 1
            a = rs.randn(*s.shape) / np.sqrt(fan_in)
        elif name == "scale":
            a = 1.0 + 0.1 * rs.randn(*s.shape)
        elif name == "var":
            a = 0.5 + rs.rand(*s.shape)
        else:
            a = 0.1 * rs.randn(*s.shape)
        return np.asarray(a, s.dtype)

    return jax.tree_util.tree_map_with_path(
        draw, variable_shapes(model, (1, *hw, 3)))


class TracedInit:
    """Wraps a flax model for the JAX CLIs that ``init`` it only to
    overwrite the result from a checkpoint: ``init`` gives zeros of the
    variables' structure (compiled in a moment), ``apply`` is the
    model's."""

    def __init__(self, model):
        self.model = model

    def init(self, rng, x, train=False):
        import jax.numpy as jnp

        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                            variable_shapes(self.model, x.shape))

    def __getattr__(self, name):
        return getattr(self.model, name)


def traced_init_patch() -> dict:
    """``run_jax`` patches under which the JAX package's ``build_model``
    gives :class:`TracedInit` models."""
    import glsdet_tpu.train.loop as jloop

    real = jloop.build_model
    return {"glsdet_tpu.train.loop:build_model":
            lambda *a, **kw: TracedInit(real(*a, **kw))}


def calibrate_batch_stats(model, variables, frames) -> dict:
    """``variables`` with every BatchNorm's running statistics taken from
    its input over ``frames`` ((N, H, W, 3) uint8, ImageNet-normalized
    here) by one train-mode ``apply`` (eager: no compile): the mean as
    it is, the variance raised to at least the median of its layer's.
    Seeded statistics let the content's signal fade through the network,
    so that every frame's best anchors score the same to float32
    precision and a ranking of them breaks the ties either way; the
    floor keeps channels of little variance from amplifying the two
    stacks' float32 differences instead."""
    import jax.numpy as jnp

    from glsdet_tpu.data.coco import IMAGENET_MEAN, IMAGENET_STD
    from glsdet_tpu.models.layers import BN_MOMENTUM

    x = ((np.asarray(frames, np.float32) - np.asarray(IMAGENET_MEAN))
         / np.asarray(IMAGENET_STD))
    zeros = jax.tree.map(np.zeros_like, variables["batch_stats"])
    # the running statistics become momentum * 0 + (1 - momentum) * batch
    _, new = model.apply({**variables, "batch_stats": zeros},
                         jnp.asarray(x, jnp.float32), train=True,
                         mutable=["batch_stats"])

    def stat(path, a, s):
        a = np.asarray(a) / (1 - BN_MOMENTUM)
        if path[-1].key == "var":
            a = np.maximum(a, np.median(a))
        return np.asarray(a, s.dtype)

    stats = jax.tree_util.tree_map_with_path(
        stat, new["batch_stats"], variables["batch_stats"])
    return {**variables, "batch_stats": stats}


def jax_checkpoint(root: str, name: str, cli_opts, seed: int,
                   ema_jitter: float = 0.05, calibration=None) -> str:
    """A JAX ``TrainState`` of ``name`` under ``cli_opts`` (KEY=VAL
    strings) as the JAX CLIs build its template, its weights
    :func:`seeded_variables` (with :func:`calibrate_batch_stats` over
    ``calibration`` frames where given) and its EMA apart from them in
    the score convolutions, written by the JAX package's
    ``save_checkpoint``; returns the orbax directory."""
    import glsdet_tpu.train.loop as jloop
    from glsdet_tpu.config import (apply_overrides, get_config,
                                   parse_cfg_options)

    cfg = apply_overrides(get_config(name), parse_cfg_options(cli_opts))
    model = jloop.build_model(cfg)
    variables = seeded_variables(model, tuple(cfg.data.img_hw), seed)
    if calibration is not None:
        variables = calibrate_batch_stats(model, variables, calibration)
    tx = jloop.build_optimizer(cfg, 1000)
    state = jloop.make_state_template(cfg, variables, tx,
                                      jax.random.PRNGKey(seed))
    # the EMA: each output channel of the score convolutions scaled by
    # 1 + ema_jitter * N(0, 1), kernel and bias alike
    rs = np.random.RandomState(seed + 7)
    factors = {}

    def ema_leaf(path, a):
        module = jax.tree_util.keystr(path[:-1])
        if not any(p in module for p in ("cls_pred", "obj_pred")):
            return np.asarray(a)
        if module not in factors:
            factors[module] = 1 + ema_jitter * rs.randn(a.shape[-1])
        return np.asarray(a * factors[module], a.dtype)

    ema = jax.tree_util.tree_map_with_path(ema_leaf,
                                           jax.device_get(state.params))
    state = state.replace(ema_params=ema)
    return jloop.save_checkpoint(root, state, 1)
