"""Port parity of the GFL family: ``GFLHead``/``GFLDet``, its train step,
its static-int8 head and the ``Detector`` facade for ``gfl_res50``,
against the JAX package on the CPU from the same flax weights.

- GFLDet (ResNet-18, FPN and head at 64 channels) forward within 5e-6
  (rtol and atol) in float32, every level's class logits and box
  distributions.
- ``build_model("gfl_res50")``: the state-dict names, shapes and the
  parameter count equal the flax tree's.
- ``make_gfl_train_step``: one float32 step of the mp_sgd recipe on the
  same normalised batch (128x128, B = 2, G = 3, one padded GT): the four
  metrics within 1e-5 relative; parameters, BN statistics and EMA within
  1e-5 of each leaf's max.  (The momentum buffers are the step's
  gradients, whose backbone BN leaves are ill-conditioned in float32 at
  this size: tests/test_torch_train_step.py.)
- The int8 GFL head (``Int8GFLHead``) against the JAX package's
  ``_int8_head_forward`` run eagerly with the same scales, layer by layer
  on JAX's codes: each tower layer's int8 codes within +-1 (at most 1e-3
  of them differing); the predictors on JAX's tower outputs within 1e-5
  of the output maximum.
- ``Detector("gfl_res50")`` (depth 18, 128x128, score threshold 1e-4)
  against the JAX ``Detector`` on the same frames: at least 95% of each
  side's detections matched by the other (same label, IoU > 0.99, score
  within 1e-4).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glsdet_tpu.apis as japis
from glsdet_tpu.config import apply_overrides as japply
from glsdet_tpu.config import get_config as jget_config
from glsdet_tpu.models import GFLDet as JGFLDet
from glsdet_tpu.models.gfl_head import GFLHead as JGFLHead
from glsdet_tpu.ops import quant_static as jq
from glsdet_tpu.train import schedules as jsched
from glsdet_tpu.train.state import TrainState as JState
from glsdet_tpu.train.steps import make_gfl_train_step as j_make_step
from glsdet_tpu_torch import apis
from glsdet_tpu_torch.config import get_config
from glsdet_tpu_torch.models import GFLDet
from glsdet_tpu_torch.models.build import build_model
from glsdet_tpu_torch.models.gfl_head import GFLHead
from glsdet_tpu_torch.ops import quant_static as tq
from glsdet_tpu_torch.ops.gn_kernel import gn_relu_quant_acc
from glsdet_tpu_torch.train import schedules
from glsdet_tpu_torch.train.steps import make_gfl_train_step
from glsdet_tpu_torch.utils.flax_import import (params_from_flax,
                                                state_dict_from_flax,
                                                train_state_from_flax)
from test_torch_two_stage import _matched
from torch_port_util import (assert_leaf_close, check_detector, flax_vars,
                             load_flax, nchw, normalized, to_np)

NC, DEPTH, FC = 10, 18, 64
HW, B, G, SPE = (128, 128), 2, 3, 100
LOSS_RTOL, LEAF_TOL = 1e-5, 1e-5
DET_OPTS = {"model.depth": DEPTH, "model.feat_channels": FC,
            "model.dtype": "float32", "data.img_hw": HW,
            "eval.score_thr": 1e-4}


def test_gfldet_forward_matches_jax():
    x = np.random.RandomState(0).randn(2, *HW, 3).astype(np.float32)
    check_detector(JGFLDet(num_classes=NC, depth=DEPTH, feat_channels=FC),
                   GFLDet(NC, DEPTH, FC,
                          generator=torch.Generator().manual_seed(0)),
                   x, tol=5e-6)


def test_build_gfl_res50_names_and_counts_match_flax():
    cfg = get_config("gfl_res50")
    model = build_model(cfg, device="cpu")
    assert type(model) is GFLDet and model.head.remat == cfg.model.remat
    jm = JGFLDet(num_classes=cfg.model.num_classes, depth=cfg.model.depth,
                 feat_channels=cfg.model.feat_channels)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = state_dict_from_flax(zeros)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
    n_flax = sum(int(np.prod(s.shape)) for s in
                 jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_flax


def make_batch(rs):
    x1 = rs.uniform(0, HW[1] - 48, (B, G))
    y1 = rs.uniform(0, HW[0] - 48, (B, G))
    bw, bh = rs.uniform(8, 40, (B, G)), rs.uniform(8, 40, (B, G))
    images = rs.randint(0, 255, (B, *HW, 3)).astype(np.uint8)
    valid = np.ones((B, G), bool)
    valid[:, -1] = False
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    return normalized({"images": images, "gt_boxes": boxes,
                       "gt_labels": rs.randint(0, NC, (B, G)).astype(
                           np.int32),
                       "gt_valid": valid})


def test_gfl_train_step_matches_jax():
    jm = JGFLDet(num_classes=NC, depth=DEPTH, feat_channels=FC)
    tx = jsched.mp_det_sgd(jsched.schedule_1x(0.01, SPE))
    variables = flax_vars(jm, np.zeros((B, *HW, 3), np.float32))
    j0 = JState.create(variables, tx, jax.random.PRNGKey(3))
    batch = make_batch(np.random.RandomState(0))
    j1, jmetrics = jax.jit(j_make_step(jm, tx, HW, NC))(
        j0, {k: jnp.asarray(v.copy()) for k, v in batch.items()})
    j1 = jax.device_get(j1)

    model = GFLDet(NC, DEPTH, FC, generator=torch.Generator().manual_seed(0))
    opt = schedules.mp_det_sgd(model.parameters(),
                               schedules.schedule_1x(0.01, SPE))
    state = train_state_from_flax(jax.device_get(j0), model, opt,
                                  torch.Generator().manual_seed(0))
    step = make_gfl_train_step(model, HW, NC)
    state, metrics = step(state, {k: torch.from_numpy(v.copy())
                                  for k, v in batch.items()})
    assert set(metrics) == set(jmetrics)
    for k, w in jmetrics.items():
        assert np.isfinite(float(w)) and float(w) > 0, k
        np.testing.assert_allclose(float(metrics[k]), float(w),
                                   rtol=LOSS_RTOL, err_msg=k)
    want = state_dict_from_flax({"params": j1.params,
                                 "batch_stats": j1.batch_stats})
    got = state.model.state_dict()
    for name, w in want.items():
        if not name.endswith("num_batches_tracked"):
            assert_leaf_close(got[name], w, name, LEAF_TOL)
    for name, w in params_from_flax(j1.ema_params).items():
        assert_leaf_close(state.ema_params[name], w, f"ema {name}", LEAF_TOL)
    assert state.step == 1 and state.optimizer.count == 1


@pytest.fixture(scope="module")
def int8_case():
    """A GFLHead at 64 channels on five random pyramid levels (16x16 down
    to 1x1, batch 2), its flax weights and the JAX package's scales."""
    rs = np.random.RandomState(1)
    feats = [rs.randn(2, s, s, FC).astype(np.float32)
             for s in (16, 8, 4, 2, 1)]
    jm = JGFLHead(num_classes=NC, feat_channels=FC)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0),
                               [jnp.asarray(f) for f in feats]))
    rs2 = np.random.RandomState(2)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.1 * rs2.randn(*a.shape).astype(np.float32)
                      if p[-1].key == "bias" else np.asarray(a)), v)
    fn = lambda vv, fs: jm.apply(vv, fs)  # noqa: E731
    scales = jq.calibrate_scales(fn, v, [[jnp.asarray(f) for f in feats]])
    tm = load_flax(GFLHead(NC, FC), v)
    return jm, v, tm, feats, scales


def test_int8_gfl_head_matches_jax(int8_case, monkeypatch):
    """Layer by layer on the JAX package's own codes: each int8 tower
    layer of the port (``QConv``, then ``gn_relu_quant_acc``'s plain
    version) fed the input codes JAX's ``_int8_head_forward`` gave that
    layer must give JAX's output codes within +-1, at most 1e-3 of them
    differing; the predictors on JAX's tower outputs give JAX's outputs.
    (Chained, one code that flips at a rounding boundary moves the next
    layers' codes too: the test_torch_quant_static.py note.)"""
    jm, v, tm, feats, scales = int8_case
    assert set(tq.calibrate_scales(tm, [[nchw(f) for f in feats]])) == set(
        scales)
    codes, tower_out = [], []
    real_conv, real_pred = jax.lax.conv_general_dilated, jq._pred_conv

    def conv(lhs, *a, **kw):
        if lhs.dtype == jnp.int8:
            codes.append(np.asarray(lhs))
        return real_conv(lhs, *a, **kw)

    def pred(x, p, dtype):
        tower_out.append(np.asarray(x))
        return real_pred(x, p, dtype)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", conv)
    monkeypatch.setattr(jq, "_pred_conv", pred)
    want = jm.apply(v, [jnp.asarray(f) for f in feats],
                    method=lambda m, fs: jq._int8_head_forward(m, fs,
                                                               scales))
    monkeypatch.undo()
    qm = tq.quantize_static(tm, scales, device="cpu")
    assert type(qm) is tq.Int8GFLHead
    assert len(codes) == 5 * 2 * 4 and len(tower_out) == 5 * 2
    n_diff = n_all = 0
    for lvl in range(5):
        # JAX runs the cls tower, then the reg tower; its predictors see
        # the reg features first
        for t_i, t in enumerate(("cls", "reg")):
            tower = getattr(qm, f"{t}_tower")
            last = tower_out[2 * lvl + 1 - t_i] / tower.s_outs[-1]
            ins = codes[8 * lvl + 4 * t_i:8 * lvl + 4 * t_i + 4]
            outs = ins[1:] + [np.round(last).astype(np.int8)]
            for i, (q_in, q_want) in enumerate(zip(ins, outs)):
                qc = tower.convs[i]
                with torch.inference_mode():
                    q = gn_relu_quant_acc(
                        qc.conv(torch.from_numpy(q_in)).contiguous(),
                        qc.deq, getattr(tower, f"gn_weight{i}"),
                        getattr(tower, f"gn_bias{i}"), tower.s_outs[i],
                        groups=32, eps=1e-6, dtype=torch.float32)
                d = np.abs(to_np(q).astype(np.int32)
                           - q_want.astype(np.int32))
                assert d.max() <= 1, (lvl, t, i)
                n_diff += int((d > 0).sum())
                n_all += d.size
        reg_j, cls_j = (torch.from_numpy(a).permute(0, 3, 1, 2)
                        for a in tower_out[2 * lvl:2 * lvl + 2])
        with torch.inference_mode():
            bp = getattr(qm, f"scale{lvl}")(qm._pred_conv(reg_j, qm.gfl_reg))
            cf = qm._pred_conv(cls_j, qm.gfl_cls)
        for g, w in ((cf, want[0][lvl]), (bp, want[1][lvl])):
            g, w = to_np(g.permute(0, 2, 3, 1)), np.asarray(w)
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    assert n_diff <= 1e-3 * n_all, (n_diff, n_all)
    with torch.inference_mode():
        cls, reg = qm([nchw(f) for f in feats])
    assert [tuple(c.shape) for c in cls] == [w.shape for w in want[0]]
    assert all(r.dtype == torch.float32 for r in reg)


def test_quantize_static_takes_a_gfldet(int8_case):
    """The whole GFLDet-18: calibrated keys are the JAX package's, and the
    head becomes the explicit int8 head."""
    x = np.random.RandomState(3).randn(1, 64, 64, 3).astype(np.float32)
    jm = JGFLDet(num_classes=NC, depth=DEPTH, feat_channels=FC)
    v = flax_vars(jm, x)
    want = jq.calibrate_scales(lambda vv, im: jm.apply(vv, im, train=False),
                               v, [jnp.asarray(x.copy())])
    tm = load_flax(GFLDet(NC, DEPTH, FC,
                          generator=torch.Generator().manual_seed(0)), v)
    got = tq.calibrate_scales(tm, [nchw(x)])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    qm = tq.quantize_static(tm, want, device="cpu")
    assert type(qm.head) is tq.Int8GFLHead
    with torch.inference_mode():
        cls, reg = qm(nchw(x))
    assert len(cls) == len(reg) == 5
    assert all(np.isfinite(to_np(t)).all() for t in cls + reg)


def test_detector_for_gfl_matches_jax(tmp_path):
    jcfg = japply(jget_config("gfl_res50"), dict(DET_OPTS))
    jmodel = JGFLDet(num_classes=NC, depth=DEPTH, feat_channels=FC)
    v = flax_vars(jmodel, np.zeros((1, *HW, 3), np.float32))
    path = str(tmp_path / "gfl.pt")
    torch.save(state_dict_from_flax(v), path)
    jd = japis.Detector.__new__(japis.Detector)
    jd.cfg = jcfg
    jd.class_names = list(apis.VISDRONE_CLASSES)
    jd.score_thr = jcfg.eval.score_thr
    jd._raw_apply = jmodel.apply
    jd._variables = jax.device_put(v)
    jd._set_fwd(jmodel.apply)
    td = apis.Detector("gfl_res50", path, options=DET_OPTS, device="cpu")
    rs = np.random.RandomState(4)
    frames = [rs.randint(0, 256, (96, 160, 3), np.uint8) for _ in range(2)]
    want = jd.detect_batch([f.copy() for f in frames])
    got = td.detect_batch([f.copy() for f in frames])
    for g, w in zip(got, want):
        assert len(g["boxes"]) > 0
        assert _matched(g, w) >= 0.95 and _matched(w, g) >= 0.95
