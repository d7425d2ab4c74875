"""The port's train step across two processes against the JAX package's
global-view step on ``data_mesh(2)`` (the conftest's 8 CPU devices), for
the three families, from one state carried across by
``utils/flax_import.py: checkpoint_from_flax``.

Each family at the size of its one-process parity file (YOLOX-nano at
64x96 as ``test_torch_yolox_train.py``, GFL and MP-Det at depth 18,
feat_channels 64, 128x128 as ``test_torch_gfl.py`` and
``test_torch_train_step.py``), global batch 2: one image a rank.  The
MP-Det recipe's clip (0.5) binds, so the clip sees the summed gradient;
beta = 1, so the contrastive and OT losses count; the dictionary update
takes the JAX step's own draw over the global batch.

Two ranks of ``tests/torch_dist_worker.py`` (a gloo group on the CPU,
no JAX) run each step in float64 and float32, and MP-Det's in float64
with its blocks checkpointed (remat).  Tolerances, those of the
one-process files:

- against the JAX step in float64 (the models in float64, the losses in
  float32 as both packages cast them): every metric within 1e-4
  relative; every parameter, BN statistic, EMA leaf and the dictionary
  within 1e-5 of the leaf's max |value|; the momentum buffers (the
  step's gradients) within 3e-3, the bound the MP-Det file sets for its
  float64 lock-step (the 2x2 and 1x1 P6/P7 maps amplify the float32
  losses' rounding through the head's GroupNorm); pointers, step and
  schedule count equal;
- against the port's own step in one process on the global batch: the
  same in float64, and in float32 the metrics and every leaf but the
  momentum buffers (in float32 those are the remainder of a
  cancellation at this size: ``test_torch_train_step.py``), the BN
  statistics within 5e-5 (``test_torch_yolox_train.py``'s bound: the
  group's statistics combine each rank's float32 ``var_mean``, one
  process's are ``F.batch_norm``'s, and YOLOX-nano's stride-32 levels
  hold 12 values a channel);
- the two ranks' states are equal, bit for bit (their digests).

The helpers of ``parallel/mesh.py`` are held to what they compute on
per-rank values in the same two ranks.
"""

import concurrent.futures
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from glsdet_tpu.models import GFLDet as JGFLDet
from glsdet_tpu.models import MPDet as JMPDet
from glsdet_tpu.models import YOLOXDetector as JYOLOX
from glsdet_tpu.parallel import data_mesh as j_data_mesh
from glsdet_tpu.train import schedules as jsched
from glsdet_tpu.train.boiw import enable_emd_training as j_enable
from glsdet_tpu.train.boiw import init_boiw as j_init_boiw
from glsdet_tpu.train.state import TrainState as JState
from glsdet_tpu.train import steps as jsteps
from glsdet_tpu_torch.utils.flax_import import (checkpoint_from_flax,
                                                optax_fields,
                                                params_from_flax,
                                                state_dict_from_flax)
import torch_dist_worker as W
from torch_port_util import assert_leaf_close, normalized
from torch_tools_util import seeded_variables

FAMILIES = ("yolox", "gfl", "mpdet")
LOSS_RTOL, LEAF_TOL, MOMENTUM_TOL = 1e-4, 1e-5, 3e-3
# float32 BatchNorm statistics: test_torch_yolox_train.py's bound (a
# mean or variance of 12 values a channel summed in another order)
BN_STATS32_TOL = 5e-5


def make_batch(family, rs):
    """uint8 frames (normalised in float32 for YOLOX and GFL, whose steps
    take them so), boxes of 8-40 px, labels 0-9, the last GT padded."""
    hw, g = W.FAMILIES[family]["hw"], W.FAMILIES[family]["g"]
    images = rs.randint(0, 255, (W.B, *hw, 3)).astype(np.uint8)
    x1 = rs.uniform(0, hw[1] - 48, (W.B, g))
    y1 = rs.uniform(0, hw[0] - 48, (W.B, g))
    bw, bh = rs.uniform(8, 40, (W.B, g)), rs.uniform(8, 40, (W.B, g))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    valid = np.ones((W.B, g), bool)
    valid[:, -1] = False
    batch = {"images": images, "gt_boxes": boxes,
             "gt_labels": rs.randint(0, W.NC, (W.B, g)).astype(np.int32),
             "gt_valid": valid}
    return batch if family == "mpdet" else normalized(batch)


def jax_side(family):
    """The JAX model in float64, its recipe and the raw step."""
    hw = W.FAMILIES[family]["hw"]
    if family == "yolox":
        model = JYOLOX(num_classes=W.NC, phi="nano", dtype=jnp.float64)
        tx = jsched.yolox_sgd(jsched.yolox_warm_cos(**W.YOLOX_SCHED))
        return model, tx, jsteps.make_yolox_train_step(model, tx, hw)
    if family == "gfl":
        model = JGFLDet(num_classes=W.NC, depth=W.DEPTH,
                        feat_channels=W.FC, dtype=jnp.float64)
        tx = jsched.mp_det_sgd(jsched.schedule_1x(0.01, W.SPE))
        return model, tx, jsteps.make_gfl_train_step(model, tx, hw, W.NC)
    model = JMPDet(num_classes=W.NC, depth=W.DEPTH, feat_channels=W.FC,
                   dtype=jnp.float64)
    tx = jsched.mp_det_sgd(jsched.schedule_1x(0.01, W.SPE),
                           grad_clip=W.MP_CLIP)
    return model, tx, jsteps.make_mpdet_train_step(
        model, tx, hw, W.NC, W.PROXIES, normalize=True)


def initial_state(family, model, tx):
    """A JAX state in float64 holding float32 values (the numbers the
    port's bridge reads), its weights drawn in numpy
    (``torch_tools_util.seeded_variables``: no compiled ``init``);
    MP-Det's dictionary (float32 in both packages) with beta 1."""
    variables = seeded_variables(model, W.FAMILIES[family]["hw"], seed=0)
    key = jax.random.PRNGKey(3)
    boiw = None
    if family == "mpdet":
        boiw = j_enable(j_init_boiw(key, W.NC, W.WORDS, W.FC, W.PROXIES))

    def f64(tree):
        return jax.tree.map(
            lambda a: (jnp.asarray(np.asarray(a, np.float32), jnp.float64)
                       if np.issubdtype(np.asarray(a).dtype, np.floating)
                       else a), jax.device_get(tree))

    with jax.enable_x64(True):
        state = JState.create(f64(variables), tx, key, boiw=boiw)
        return state.replace(opt_state=f64(state.opt_state),
                             ema_params=f64(state.ema_params))


def dictionary_noise(jstate, family):
    """The JAX step's uniform draw for the dictionary update, over the
    global batch's anchors (float64, as inside the x64 step)."""
    hw = W.FAMILIES[family]["hw"]
    n = W.B * sum(-(-hw[0] // s) * -(-hw[1] // s)
                  for s in (8, 16, 32, 64, 128))
    with jax.enable_x64(True):
        rng, _ = jax.random.split(jstate.rng)
        return np.array(jax.random.uniform(rng, (W.NC + 1, n)))


def lower_mesh_step(raw, jstate, batch):
    """The JAX step jitted over ``data_mesh(2)`` (the state replicated,
    the batch sharded on its first axis), lowered, and its arguments."""
    mesh = j_data_mesh(2)
    repl = NamedSharding(mesh, P())
    rows = NamedSharding(mesh, P("data"))
    with jax.enable_x64(True):
        args = (jax.device_put(jstate, repl),
                {k: jax.device_put(jnp.asarray(v.copy()), rows)
                 for k, v in batch.items()})
        return jax.jit(raw, in_shardings=(repl, rows)).lower(*args), args


def mesh_step(compiled, args):
    """Run a compiled :func:`lower_mesh_step`: the new state and the
    metrics."""
    with jax.enable_x64(True):
        new, metrics = compiled(*args)
        new = jax.device_get(new)
    return new, {k: float(v) for k, v in metrics.items()}


def unflatten(z, prefix):
    return {k[len(prefix):]: z[k] for k in z if k.startswith(prefix)}


def assert_metrics_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=LOSS_RTOL, err_msg=k)


def assert_matches_jax(z, jstate):
    """A worker's state (flat arrays) against the JAX state."""
    want = state_dict_from_flax({"params": jstate.params,
                                 "batch_stats": jstate.batch_stats})
    for name, w in want.items():
        if not name.endswith("num_batches_tracked"):
            assert_leaf_close(z[f"model/{name}"], w, name, LEAF_TOL)
    for name, w in params_from_flax(jstate.ema_params).items():
        assert_leaf_close(z[f"ema/{name}"], w, f"ema {name}", LEAF_TOL)
    (trace,) = optax_fields(jstate.opt_state, "trace")
    for name, w in params_from_flax(trace).items():
        assert_leaf_close(z[f"momentum/{name}"], w, f"momentum {name}",
                          MOMENTUM_TOL)
    if jstate.boiw is not None:
        assert_leaf_close(z["boiw/embedding"], jstate.boiw.embedding,
                          "boiw embedding", LEAF_TOL)
        np.testing.assert_array_equal(z["boiw/ptr"],
                                      np.asarray(jstate.boiw.ptr))
    assert int(z["step"]) == int(jstate.step)
    (count,) = optax_fields(jstate.opt_state, "count")
    assert int(z["count"]) == int(count)


def assert_states_close(got, want, float64):
    for k, w in want.items():
        if k.startswith("metric/") or k.endswith("num_batches_tracked"):
            continue
        if k.startswith("momentum/") and not float64:
            continue
        tol = LEAF_TOL
        if k.startswith("momentum/"):
            tol = MOMENTUM_TOL
        elif "running_" in k and not float64:
            tol = BN_STATS32_TOL
        if np.issubdtype(w.dtype, np.floating):
            assert_leaf_close(got[k], w, k, tol)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Per family: the JAX mesh step, the two ranks' float32 and float64
    steps and the port's one-process steps, from the same state and
    batch.  The ranks and the port's one-process steps run while the JAX
    steps compile."""
    d = str(tmp_path_factory.mktemp("dist_step"))
    sides, fixtures = {}, {}
    for i, family in enumerate(FAMILIES):
        model, tx, raw = jax_side(family)
        j0 = initial_state(family, model, tx)
        batch = make_batch(family, np.random.RandomState(i))
        # the state's values are float32 numbers (initial_state): the
        # file holds them in float32
        ckpt = checkpoint_from_flax(jax.device_get(j0))
        torch.save(torch.utils._pytree.tree_map(
            lambda t: t.float() if torch.is_tensor(t)
            and t.dtype == torch.float64 else t, ckpt),
            os.path.join(d, f"{family}_state.pt"))
        np.savez(os.path.join(d, f"{family}_batch.npz"), **batch)
        noise = None
        if family == "mpdet":
            noise = dictionary_noise(j0, family)
            np.save(os.path.join(d, "mpdet_noise.npy"), noise)
        sides[family] = (raw, j0, batch)
        fixtures[family] = (ckpt, batch, noise)
    wait = W.launch({"parts": ["collectives", "steps"],
                     "families": list(FAMILIES),
                     "dtypes": ["float64", "float32"]}, d)
    # XLA compiles a family's step in a thread (it releases the GIL)
    # while the next one is traced
    pool = concurrent.futures.ThreadPoolExecutor(len(FAMILIES))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)            # as the ranks: the CPU is shared
    try:
        compiling = {}
        for family in FAMILIES:
            lowered, args = lower_mesh_step(*sides[family])
            compiling[family] = (pool.submit(lowered.compile), args)
        out = {}
        for family in FAMILIES:
            compiled, args = compiling[family]
            one = {name: W.run_step(family, W.DTYPES[name], *fixtures[family])
                   for name in ("float64", "float32")}
            out[family] = {"jax": mesh_step(compiled.result(), args),
                           "one": one}
    finally:
        torch.set_num_threads(threads)
        pool.shutdown()
        wait()
    def ranks(tag):
        return [dict(np.load(os.path.join(d, f"step_{tag}_r{r}.npz")))
                for r in range(2)]

    for family in FAMILIES:
        for name in ("float64", "float32"):
            out[family][name] = ranks(f"{family}_{name}")
    out["mpdet"]["remat"] = ranks("mpdet_remat_float64")
    out["collectives"] = [dict(np.load(os.path.join(
        d, f"collectives_r{r}.npz"))) for r in range(2)]
    shutil.rmtree(d)            # the states are large; the arrays are read
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_two_ranks_match_the_jax_mesh_step(run, family):
    jnew, jmetrics = run[family]["jax"]
    z = run[family]["float64"][0]
    assert all(np.isfinite(v) for v in jmetrics.values())
    if family == "mpdet":
        assert jmetrics["loss_emb"] > 0 and jmetrics["loss_op"] > 0
    assert_metrics_close(unflatten(z, "metric/"), jmetrics)
    assert_matches_jax(z, jnew)


@pytest.mark.parametrize("name", ["float64", "float32"])
@pytest.mark.parametrize("family", FAMILIES)
def test_two_ranks_match_one_process(run, family, name):
    """The two ranks' step against the port's step on the whole batch in
    one process; the ranks' states equal."""
    r0, r1 = run[family][name]
    metrics, arrays = run[family]["one"][name]
    assert_metrics_close(unflatten(r0, "metric/"), metrics)
    assert_states_close(r0, arrays, float64=name == "float64")
    assert str(r1["digest"]) == str(r0["digest"])


def test_two_ranks_with_remat(run):
    """MP-Det with its blocks checkpointed: the backward's recomputed
    forward issues the same collectives on both ranks, BatchNorm's
    running statistics still move once, and the step is the JAX mesh
    step."""
    jnew, jmetrics = run["mpdet"]["jax"]
    r0, r1 = run["mpdet"]["remat"]
    assert_metrics_close(unflatten(r0, "metric/"), jmetrics)
    assert_matches_jax(r0, jnew)
    assert int(r0["model/backbone.stem.bn.num_batches_tracked"]) == 1
    assert str(r1["digest"]) == str(r0["digest"])


def test_collectives(run):
    """Sums, gathers (rank order), rows of the ranks' concatenation with
    the gradient on the owner's rows only, a broadcast and a replicated
    module from rank 0, and metrics summed except the replicated ones."""
    x = [np.arange(6.0).reshape(3, 2) + 10 * r for r in range(2)]
    cat = np.concatenate(x)
    idx = np.array([[5, 0], [1, 3]])
    weight = np.arange(1, 5, dtype=np.float64).reshape(2, 2, 1)
    for r, z in enumerate(run["collectives"]):
        np.testing.assert_array_equal(z["sum"], x[0] + x[1])
        np.testing.assert_array_equal(z["gather"], np.stack(x))
        np.testing.assert_array_equal(z["labels"], [[0, 7], [1, 7]])
        np.testing.assert_array_equal(z["rows"], cat[idx])
        grad = np.zeros((6, 2))
        np.add.at(grad, idx, np.broadcast_to(weight, (2, 2, 2)))
        np.testing.assert_array_equal(z["rows_grad"], grad[3 * r:3 * r + 3])
        np.testing.assert_array_equal(z["broadcast"], np.zeros(4))
        np.testing.assert_array_equal(z["replicated"], np.zeros((2, 3)))
        np.testing.assert_array_equal(z["metrics"], [3.0, 5.0])
