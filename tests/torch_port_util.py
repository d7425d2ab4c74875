"""Shared helpers of the ``test_torch_*`` parity tests: JAX package vs
the ``glsdet_tpu_torch`` port, fed the same weights and inputs.

Inputs are numpy arrays made from a seed and copied before each stack
sees them (``torch.from_numpy`` and ``jnp.asarray`` alias numpy memory
on the CPU).  Weights come from ``model.init(PRNGKey(0), ...)`` in flax
and reach torch through ``utils/flax_import.py``.
"""

from __future__ import annotations

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu_torch.utils.flax_import import state_dict_from_flax


def _share_cores() -> None:
    """Under pytest-xdist every worker imports this module while it
    collects, so this sets each worker's torch intra-op pool to its share
    of the cores (at least 2).  By default each worker starts one thread
    per core, and the oversubscribed, spinning pools made the port's CPU
    runs several times slower (the heavy port test files took 488 s at 6
    workers on 8 cores, 219 s with 2 threads each).  A run without
    workers keeps torch's default."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(2, (os.cpu_count() or 1) // workers))


_share_cores()


# The facades' test configs: YOLOX-nano (``coarse_det``) at 64x64 and
# MP-Det depth 18 (``mp_det_res50``), in float32 (the JAX default is
# bfloat16), buckets (128, 256), coarse threshold 1e-4.
COARSE_OPTS = {"model.phi": "nano", "model.dtype": "float32",
               "data.img_hw": (64, 64), "eval.coarse_score_thr": 1e-4,
               "eval.mosaic_buckets": (128, 256)}
MP_OPTS = {"model.depth": 18, "model.dtype": "float32"}


def jax_two_stage_facade(variables=None):
    """The JAX package's ``TwoStageDetector`` at COARSE_OPTS / MP_OPTS
    with its other defaults, its ``init_detector`` given ``variables``
    (config name -> flax variables; none where the test only reads the
    facade's ``_pipe_kwargs`` and ``_filter``)."""
    import glsdet_tpu.apis as japis
    from glsdet_tpu.config import apply_overrides, get_config
    from glsdet_tpu.train.loop import build_model

    def init_detector(config_name, checkpoint=None, use_ema=True,
                      options=None):
        cfg = apply_overrides(get_config(config_name), dict(options or {}))
        return cfg, build_model(cfg), (variables or {}).get(config_name)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japis, "init_detector", init_detector)
        return japis.TwoStageDetector(
            "coarse_det", None, "mp_det_res50", None,
            coarse_options=COARSE_OPTS, mp_options=MP_OPTS)


def pipe_kwargs(jdet) -> dict:
    """The JAX facade's pipeline arguments without its weights, as the
    port takes them."""
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in jdet._pipe_kwargs.items()
            if k not in ("coarse_vars", "mp_vars")}


def flax_vars(module, x_nhwc: np.ndarray, seed: int = 0,
              perturb: bool = True) -> dict:
    """``module.init(PRNGKey(seed))`` at ``x_nhwc``'s shape (jitted: one
    compile is several times faster than eager init).  ``perturb`` replaces the
    trivial constant inits (BN stats 0/1, norm scales 1, zero biases) by
    random values, so a transposed or misnamed leaf cannot pass."""
    init = jax.jit(lambda key, x: module.init(key, x, train=False))
    variables = jax.device_get(init(jax.random.PRNGKey(seed),
                                    jnp.asarray(x_nhwc.copy())))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if not perturb:
        return variables
    rs = np.random.RandomState(seed + 1)

    def jitter(path, a):
        name = path[-1].key
        if name == "var":
            return np.asarray(0.5 + rs.rand(*a.shape), np.float32)
        if name in ("mean", "bias"):
            return np.asarray(0.1 * rs.randn(*a.shape), np.float32)
        if name == "scale":
            return np.asarray(1.0 + 0.1 * rs.randn(*a.shape), np.float32)
        return a

    return jax.tree_util.tree_map_with_path(jitter, variables)


def load_flax(torch_module: torch.nn.Module, variables: dict):
    """Load flax variables into the port module (strict) in eval mode."""
    torch_module.load_state_dict(state_dict_from_flax(variables),
                                 strict=True)
    return torch_module.eval()


def check_detector(jmodel, tmodel: torch.nn.Module, x_nhwc: np.ndarray,
                   tol: float = 1e-4) -> None:
    """Flax detector vs its port on the same input and weights: every
    per-level output map agrees to ``rtol = atol = tol`` in float32."""
    variables = flax_vars(jmodel, x_nhwc)
    # jitted: one compile is several times faster than eager dispatch
    apply = jax.jit(lambda v, im: jmodel.apply(v, im, train=False))
    want = apply(variables, x_nhwc.copy())
    tmodel = load_flax(tmodel, variables)
    with torch.inference_mode():
        got = tmodel(nchw(x_nhwc))
    assert len(got) == len(want)
    for g_maps, w_maps in zip(got, want):
        assert len(g_maps) == len(w_maps)
        for g, w in zip(g_maps, w_maps):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=tol,
                                       atol=tol)


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc.copy()).permute(0, 3, 1, 2)


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def assert_leaf_close(got, want, what, tol: float = 1e-5) -> None:
    """``got`` within ``tol`` of ``want``'s max |value| (a state leaf)."""
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def normalized(batch: dict) -> dict:
    """A train batch with its uint8 frames ImageNet-normalised in float32
    numpy, for steps built with ``normalize=False`` in both packages."""
    out = dict(batch)
    out["images"] = ((batch["images"].astype(np.float32) - IMAGENET_MEAN)
                     / IMAGENET_STD)
    return out


def rand_nhwc(shape, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def yolox_fixture(seed: int, hw=(64, 96), b: int = 3, g: int = 6,
                  nc: int = 4, strides=(8, 16, 32)) -> dict:
    """Seeded YOLOX head outputs and padded GTs for the SimOTA and loss
    parity tests: raw cls/reg/obj maps flattened to (B, A, ...), the
    priors, and GTs of 4-40 px with the last two slots of each image
    padding.  Image 1 has two GTs competing for the same anchors (one
    box and its copy moved by a pixel, other labels); image 2 has no
    valid GT."""
    from glsdet_tpu_torch.ops.priors import grid_points

    rs = np.random.RandomState(seed)
    centers, stride_v, _ = grid_points(hw, strides, offset=0.5)
    a = centers.shape[0]
    cls = (2.0 * rs.randn(b, a, nc)).astype(np.float32)
    reg = np.concatenate([0.5 * rs.randn(b, a, 2),
                          0.6 + 0.5 * rs.randn(b, a, 2)], -1).astype(
        np.float32)
    obj = (2.0 * rs.randn(b, a)).astype(np.float32)
    x1 = rs.uniform(0, hw[1] - 40, (b, g))
    y1 = rs.uniform(0, hw[0] - 40, (b, g))
    w = rs.uniform(4, 40, (b, g))
    h = rs.uniform(4, 40, (b, g))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    labels = rs.randint(0, nc, (b, g)).astype(np.int32)
    boxes[1, 1] = boxes[1, 0] + np.float32(1.0)
    labels[1, 1] = (labels[1, 0] + 1) % nc
    valid = np.ones((b, g), bool)
    valid[:, -2:] = False
    valid[2] = False
    return {"cls": cls, "reg": reg, "obj": obj,
            "priors_cxy": centers.astype(np.float32),
            "priors_stride": stride_v.astype(np.float32),
            "gt_boxes": boxes, "gt_labels": labels, "gt_valid": valid}


def write_png_dataset(root):
    """8 PNG frames (written by ``cv2.imwrite``) of three sizes in turn,
    each with 1-6 boxes of classes 0-2, and their COCO json; returns
    ``(ann_file, img_root)``."""
    import json

    import cv2

    n, shapes = 8, ((60, 100), (80, 64), (50, 90))
    rs = np.random.RandomState(0)
    img_root = os.path.join(root, "img")
    os.makedirs(img_root, exist_ok=True)
    images, anns = [], []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        cv2.imwrite(os.path.join(img_root, f"{i}.png"),
                    rs.randint(0, 256, (h, w, 3), np.uint8))
        images.append({"id": i + 1, "file_name": f"{i}.png",
                       "width": w, "height": h})
        for _ in range(rs.randint(1, 7)):
            x, y = rs.uniform(0, w - 20), rs.uniform(0, h - 20)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(rs.randint(0, 3)),
                         "bbox": [x, y, rs.uniform(3, 19),
                                  rs.uniform(3, 19)], "iscrowd": 0})
    ann_file = os.path.join(root, "ann.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": k, "name": str(k)}
                                  for k in range(3)]}, f)
    return ann_file, img_root


# ── reference naming (the inverse of the JAX package's key rewrites) ──
# The same helper lives in chip_smoke.py, which cannot import this module
# (it imports jax); tests/test_torch_weights_import.py holds it against
# ``_map_yolox_drone`` / ``_map_mpdet`` of the JAX package.

_PAFPN = {"reduce5": "lateral_conv0", "reduce4": "reduce_conv1",
          "td_csp4": "C3_p4", "td_csp3": "C3_p3", "bu_down3": "bu_conv2",
          "bu_csp4": "C3_n3", "bu_down4": "bu_conv1", "bu_csp5": "C3_n4"}


def _undw(rest):
    return re.sub(r"^pw\.", "pconv.", re.sub(r"^dw\.", "dconv.", rest))


def _uncsp(rest):
    for port, ref in (("main_conv.", "conv1."), ("short_conv.", "conv2."),
                      ("final_conv.", "conv3.")):
        if rest.startswith(port):
            return ref + rest[len(port):]
    rest = re.sub(r"^block(\d+)\.conv2_dw\.dw\.", r"m.\1.conv2.dconv.", rest)
    rest = re.sub(r"^block(\d+)\.conv2_dw\.pw\.", r"m.\1.conv2.pconv.", rest)
    return re.sub(r"^block(\d+)\.", r"m.\1.", rest)


def yolox_drone_key(key):
    """A port YOLOX key -> the yolox-drone ``YoloBody`` key."""
    m = re.match(r"^backbone\.stem\.conv\.(.*)$", key)
    if m:
        return f"backbone.backbone.stem.conv.{m[1]}"
    m = re.match(r"^backbone\.dark(\d)_down\.(.*)$", key)
    if m:
        return f"backbone.backbone.dark{m[1]}.0.{_undw(m[2])}"
    m = re.match(r"^backbone\.spp\.(.*)$", key)
    if m:
        return f"backbone.backbone.dark5.1.{m[1]}"
    m = re.match(r"^backbone\.dark(\d)_csp\.(.*)$", key)
    if m:
        return (f"backbone.backbone.dark{m[1]}."
                f"{2 if m[1] == '5' else 1}.{_uncsp(m[2])}")
    m = re.match(r"^neck\.([A-Za-z0-9_]+)\.(.*)$", key)
    if m:
        rest = _uncsp(m[2]) if "csp" in m[1] else _undw(m[2])
        return f"backbone.{_PAFPN[m[1]]}.{rest}"
    m = re.match(r"^head\.stem(\d+)\.(.*)$", key)
    if m:
        return f"head.stems.{m[1]}.{m[2]}"
    m = re.match(r"^head\.(cls|reg)(\d+)_(\d+)\.(.*)$", key)
    if m:
        return f"head.{m[1]}_convs.{m[2]}.{m[3]}.{_undw(m[4])}"
    m = re.match(r"^head\.(cls|reg|obj)_pred(\d+)\.(.*)$", key)
    if m:
        return f"head.{m[1]}_preds.{m[2]}.{m[3]}"
    raise KeyError(key)


_MMDET = (
    (r"^backbone\.stem\.conv\.", "backbone.conv1."),
    (r"^backbone\.stem\.bn\.", "backbone.bn1."),
    (r"^backbone\.layer(\d)_(\d+)\.conv(\d)\.conv\.",
     r"backbone.layer\1.\2.conv\3."),
    (r"^backbone\.layer(\d)_(\d+)\.conv(\d)\.bn\.",
     r"backbone.layer\1.\2.bn\3."),
    (r"^backbone\.layer(\d)_(\d+)\.down\.conv\.",
     r"backbone.layer\1.\2.downsample.0."),
    (r"^backbone\.layer(\d)_(\d+)\.down\.bn\.",
     r"backbone.layer\1.\2.downsample.1."),
    (r"^neck\.lateral(\d+)\.", r"neck.lateral_convs.\1.conv."),
    (r"^neck\.fpn_conv(\d+)\.", r"neck.fpn_convs.\1.conv."),
    (r"^head\.(cls|reg)_conv(\d+)\.", r"bbox_head.\1_convs.\2."),
    (r"^head\.scale(\d+)\.scale$", r"bbox_head.scales.\1.scale"),
    (r"^head\.", "bbox_head."),
)


def mmdet_key(key):
    """A port MP-Det/GFL key -> the mmdet key (FPN extra convs follow
    the three per-level ones in ``fpn_convs``)."""
    m = re.match(r"^neck\.extra_conv(\d+)\.(.*)$", key)
    if m:
        return f"neck.fpn_convs.{int(m[1]) + 3}.conv.{m[2]}"
    for pat, rep in _MMDET:
        if re.match(pat, key):
            return re.sub(pat, rep, key)
    raise KeyError(key)


def reference_checkpoint(state_dict, family, boiw=None, reg_max=16):
    """What a reference repo saves for a port model: yolox-drone naming
    as a bare state dict (``family="yolox"``), or mmdet naming wrapped as
    mmcv ``{"meta", "state_dict"}`` with ``integral.project`` and, given
    ``boiw`` (a ``BoIWState``), MPHead's dictionary buffers
    (``family="mpdet"``)."""
    name = yolox_drone_key if family == "yolox" else mmdet_key
    ref = {name(k): v.detach().clone() for k, v in state_dict.items()}
    if family == "yolox":
        return ref
    ref["bbox_head.integral.project"] = torch.linspace(0, reg_max,
                                                       reg_max + 1)
    if boiw is not None:
        ref["bbox_head._embedding"] = boiw.embedding.detach().clone()
        ref["bbox_head._pos_embedding_ptr"] = boiw.ptr.detach().clone()
        ref["bbox_head._proxies_prob"] = boiw.proxies_prob.detach().clone()
    return {"meta": {"epoch": 12, "mmdet_version": "2.x"},
            "state_dict": ref}
