"""Port parity of YOLOX training: ``make_yolox_train_step`` of the port vs
the JAX package's, from one state carried across by
``utils/flax_import.py: train_state_from_flax``, and the multi-scale
resize (``resize_from``) against ``jax.image.resize``.

YOLOX-nano (depthwise), 10 classes, 64x96, batch 2, G = 4 (one padded
GT), the yolox_sgd recipe (Nesterov, weight decay on rank >= 2 tensors)
in its warmup, so that the learning rate moves every step (0, 6.25e-4,
2.5e-3).  The lock-step stays in the warmup because of how far one step
moves this random-init model: at the full rate 0.01 a depthwise kernel
moves by about 3x its max in one step, and the float32 rounding of the
losses (which both packages compute in float32 even in a float64 run;
measured on the gradients: 3e-7 of a leaf's max) then reaches 1e-6 of
that kernel.  The schedule itself is held to optax's over 700 steps in
test_torch_train_ops.py.

Both packages take the same normalised float32 images
(``normalize=False``): at this size one step's gradients move by 7e-5 of
a leaf's max when the inputs move by one float32 ulp (measured: the JAX
step normalising inside ``jit`` against outside it), so the uint8
contract is held separately, port against port: ``normalize=True`` on
uint8 frames gives the same step, bit for bit, as the frames normalised
first.

- One float32 step: each metric within 1e-5 relative (``num_fg`` equal),
  parameters and EMA within 1e-5 of each leaf's max, BN statistics
  within 5e-5: flax computes a batch's variance as E[x^2] - E[x]^2 in
  float32, which loses digits where the mean is large against the spread
  (measured: 1.04e-5 on the stride-32 head stem, 12 values a channel);
  in float64 they are held to 1e-6.
- Three lock-step steps in float64 (the models in float64, the losses in
  float32 as both packages cast them), the port started from the JAX
  state before each: metrics within 1e-5 relative; parameters, BN
  statistics, EMA and momentum buffers within 1e-6 of each leaf's max;
  the step and the schedule count equal.  One of the three runs with
  ``use_l1``.
- ``resize_from`` shrinking (96 -> 64) and growing (64 -> 96): the
  port's resize within 1e-4 of the largest pixel value (255) of
  ``jax.image.resize``, its weights equal to JAX's; one float32 step
  each way against the JAX step.
"""

import jax
import jax.numpy as jnp
import jax._src.image.scale as jscale
import numpy as np
import pytest
import torch

from glsdet_tpu.models import YOLOXDetector as JYOLOX
from glsdet_tpu.train import schedules as jsched
from glsdet_tpu.train.loop import family_strides as j_family_strides
from glsdet_tpu.train.state import TrainState as JState
from glsdet_tpu.train.steps import make_yolox_train_step as j_make_step
from glsdet_tpu_torch.models import YOLOXDetector
from glsdet_tpu_torch.ops.image import bilinear_weights, resize_bilinear
from glsdet_tpu_torch.train import schedules
from glsdet_tpu_torch.train.loop import family_strides
from glsdet_tpu_torch.train.steps import make_yolox_train_step
from glsdet_tpu_torch.utils.flax_import import (optax_fields,
                                                params_from_flax,
                                                state_dict_from_flax,
                                                train_state_from_flax)
from torch_port_util import (assert_leaf_close, flax_vars, normalized,
                             to_np)

HW, B, G, NC = (64, 96), 2, 4, 10
SCHED = dict(base_lr=0.01, warmup_steps=4, total_steps=20, no_aug_steps=4)
LOSS_RTOL, LEAF32_TOL, LEAF64_TOL = 1e-5, 1e-5, 1e-6
BN_STATS32_TOL = 5e-5
RESIZE_TOL = 1e-4 * 255.0


def make_batch(rs, hw=HW):
    """uint8 frames, boxes of 6-30 px, labels 0-9, the last GT of each
    image padded."""
    images = rs.randint(0, 255, (B, *hw, 3)).astype(np.uint8)
    x1 = rs.uniform(0, hw[1] - 32, (B, G))
    y1 = rs.uniform(0, hw[0] - 32, (B, G))
    bw, bh = rs.uniform(6, 30, (B, G)), rs.uniform(6, 30, (B, G))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    labels = rs.randint(0, NC, (B, G)).astype(np.int32)
    valid = np.ones((B, G), bool)
    valid[:, -1] = False
    return {"images": images, "gt_boxes": boxes, "gt_labels": labels,
            "gt_valid": valid}


def torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


class JaxSide:
    """The JAX YOLOX-nano in ``dtype``, yolox_sgd and the jitted steps
    (traced and run with 64-bit types on for float64)."""

    def __init__(self, dtype=jnp.float32):
        self.dtype = dtype
        self.model = JYOLOX(num_classes=NC, phi="nano", dtype=dtype)
        self.tx = jsched.yolox_sgd(jsched.yolox_warm_cos(**SCHED))
        self.steps = {}

    def step(self, **kw):
        key = tuple(sorted(kw.items()))
        if key not in self.steps:
            kw.setdefault("img_hw", HW)
            self.steps[key] = jax.jit(j_make_step(
                self.model, self.tx, normalize=False, **kw))
        return self.steps[key]

    def x64(self):
        return jax.enable_x64(self.dtype == jnp.float64)

    def initial_state(self):
        variables = flax_vars(self.model, np.zeros((B, *HW, 3), np.float32))
        with self.x64():
            return self.representable(JState.create(
                self.cast(variables), self.tx, jax.random.PRNGKey(3)))

    def cast(self, tree):
        return jax.tree.map(lambda a: jnp.asarray(a, self.dtype), tree)

    def representable(self, state):
        """``state`` with its floats rounded to float32 values, the numbers
        the port's bridge reads."""
        def r(t):
            return jax.tree.map(
                lambda a: (self.cast(np.asarray(a, np.float32))
                           if np.issubdtype(np.asarray(a).dtype, np.floating)
                           else a), jax.device_get(t))
        with self.x64():
            return state.replace(params=r(state.params),
                                 batch_stats=r(state.batch_stats),
                                 ema_params=r(state.ema_params),
                                 opt_state=r(state.opt_state))

    def run(self, state, batch, **kw):
        with self.x64():
            new, metrics = self.step(**kw)(
                state, {k: jnp.asarray(v.copy()) for k, v in batch.items()})
            new = jax.device_get(new)
        return new, {k: float(v) for k, v in metrics.items()}


def port_side(jstate, dtype=torch.float32, normalize=False, **kw):
    model = YOLOXDetector(NC, "nano",
                          generator=torch.Generator().manual_seed(0)).to(dtype)
    opt = schedules.yolox_sgd(model.parameters(),
                              schedules.yolox_warm_cos(**SCHED))
    state = train_state_from_flax(jax.device_get(jstate), model, opt,
                                  torch.Generator().manual_seed(0))
    kw.setdefault("img_hw", HW)
    return state, make_yolox_train_step(model, normalize=normalize, **kw)


def assert_states_match(state, jstate, tol, momentum=False,
                        stats_tol=None):
    want = state_dict_from_flax({"params": jstate.params,
                                 "batch_stats": jstate.batch_stats})
    got = state.model.state_dict()
    for name, w in want.items():
        if not name.endswith("num_batches_tracked"):
            t = stats_tol if "running" in name and stats_tol else tol
            assert_leaf_close(got[name], w, name, t)
    named = dict(state.model.named_parameters())
    if momentum:
        (trace,) = optax_fields(jstate.opt_state, "trace")
        for name, w in params_from_flax(trace).items():
            assert_leaf_close(
                state.optimizer.state[named[name]]["momentum_buffer"], w,
                f"momentum {name}", tol)
    for name, w in params_from_flax(jstate.ema_params).items():
        assert_leaf_close(state.ema_params[name], w, f"ema {name}", tol)
    assert state.step == int(jstate.step)
    (count,) = [c for c in optax_fields(jstate.opt_state, "count")]
    assert state.optimizer.count == int(count)


def assert_metrics_match(metrics, jmetrics):
    assert set(metrics) == set(jmetrics)
    for k, w in jmetrics.items():
        assert np.isfinite(w), k
        np.testing.assert_allclose(float(metrics[k]), w, rtol=LOSS_RTOL,
                                   atol=0, err_msg=k)


@pytest.fixture(scope="module")
def jax32():
    side = JaxSide()
    return side, side.initial_state()


@pytest.fixture(scope="module")
def jax64():
    side = JaxSide(jnp.float64)
    return side, side.initial_state()


def test_one_step_matches_jax(jax32):
    side, j0 = jax32
    batch = normalized(make_batch(np.random.RandomState(0)))
    j1, jmetrics = side.run(j0, batch)
    state, step = port_side(j0)
    state, metrics = step(state, torch_batch(batch))
    assert jmetrics["num_fg"] > 0 and jmetrics["loss_l1"] == 0
    assert_metrics_match(metrics, jmetrics)
    assert_states_match(state, j1, LEAF32_TOL, stats_tol=BN_STATS32_TOL)


def test_uint8_frames_normalised_inside_the_step(jax32):
    """``normalize=True`` on uint8 frames is the same step as the frames
    normalised first: equal metrics and states."""
    _, j0 = jax32
    batch = make_batch(np.random.RandomState(0))
    runs = []
    for norm, b in ((True, batch), (False, normalized(batch))):
        state, step = port_side(j0, normalize=norm)
        state, metrics = step(state, torch_batch(b))
        runs.append((metrics, state.model.state_dict()))
    (m0, s0), (m1, s1) = runs
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


@pytest.mark.parametrize("k", [0, 1, 2])
def test_lockstep_steps_match_jax(jax64, k):
    """Step k of a three-step float64 JAX trajectory (the last with
    use_l1), the port started from the JAX state before it."""
    side, jstate = jax64
    rs = np.random.RandomState(10)
    batches = [normalized(make_batch(rs)) for _ in range(3)]
    flags = [dict(), dict(), dict(use_l1=True)]
    for i in range(k):
        jstate, _ = side.run(jstate, batches[i], **flags[i])
    jstate = side.representable(jstate)
    j_next, jmetrics = side.run(jstate, batches[k], **flags[k])
    state, step = port_side(jstate, torch.float64, **flags[k])
    state, metrics = step(state, torch_batch(batches[k]))
    if flags[k]:
        assert jmetrics["loss_l1"] > 0
    assert_metrics_match(metrics, jmetrics)
    assert_states_match(state, j_next, LEAF64_TOL, momentum=True)


@pytest.mark.parametrize("src,dst", [((96, 96), (64, 64)),
                                     ((64, 64), (96, 96)),
                                     ((96, 64), (64, 96))])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.RandomState(1).randint(0, 255, (2, *src, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3),
                                       "bilinear"))
    got = to_np(resize_bilinear(torch.from_numpy(x.copy()), dst))
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)
    linear = jscale._kernels[jscale.ResizeMethod.LINEAR]
    for m, n in zip(src, dst):
        if m != n:
            jw = np.asarray(jscale.compute_weight_mat(m, n, n / m, 0.0,
                                                      linear, True))
            np.testing.assert_array_equal(bilinear_weights(m, n), jw)


@pytest.mark.parametrize("src", [(96, 144), (48, 64)])
def test_resize_from_step_matches_jax(jax32, src):
    """The multi-scale step: batches at ``src``, trained at 64x96 (one
    shrinking, one growing): the images resized on the device, the GT
    boxes scaled by the ratio."""
    side, j0 = jax32
    batch = normalized(make_batch(np.random.RandomState(2), hw=src))
    batch["gt_boxes"] *= np.float32(src[0] / HW[0])
    j1, jmetrics = side.run(j0, batch, resize_from=src)
    state, step = port_side(j0, resize_from=src)
    state, metrics = step(state, torch_batch(batch))
    assert jmetrics["num_fg"] > 0
    assert_metrics_match(metrics, jmetrics)
    assert_states_match(state, j1, LEAF32_TOL, stats_tol=BN_STATS32_TOL)


@pytest.mark.parametrize("family", ["yolox", "ffa", "mpdet", "gfl"])
def test_family_strides_match_jax(family):
    assert family_strides(family) == tuple(j_family_strides(family))
