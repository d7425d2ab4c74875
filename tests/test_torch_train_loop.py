"""The port's ``train()`` against the JAX package's, and its checkpoints.

Stubbed steps: both loops run with ``build_model`` and the
``make_*_train_step`` factories replaced, in this test only, by a tiny
model and steps that record what they were given (the family, size,
L1 switch and strides of each step, and a digest of every batch), with
``update_ot``, ``enable_emd_training``, ``save_checkpoint`` and
``eval_fn`` recording the step count when they fire.  The JAX package's
``jax.jit`` is bypassed inside its loop module so the records are
taken on each call, and its threaded ``train_loader`` is replaced by the
same stream built on demand (the port runs with ``num_workers=0``): a
producer thread makes the moment of the last-epochs mode switch a race,
and with it the batches around the switch.  The event sequences (steps
with batch digests, OT updates, the beta switch, checkpoint and eval
epochs, the ``train.log.json`` entries without their ``time``) must be
equal, under the default YOLOX recipe, MP-Det's OT cadence, GFL, the
freeze recipe, iteration-based mode, multiscale and groups of
``train.steps_per_call`` steps (the JAX package's ``lax.scan`` group
replaced by the same steps in a Python loop, so that the stubs record
each; the port's loop runs a group as its K steps back to back):
groups of 3 in epochs of 4 steps, whose single-step tails move the hooks
off the group stride, under a ``max_steps`` cut, and across the mode
switch.

Real steps, the port alone: YOLOX-nano and MP-Det-18 at 64x64 train
with finite losses; a checkpoint restores step, weights, BN statistics,
optimizer, EMA, generator and BoIW bit for bit; ``resume`` starts at the
checkpoint's epoch and wins over ``load_from``; frozen parameters stay
bit-unchanged while their BN statistics move; ``load_weights`` skips
mismatched shapes; ``apis.init_detector`` serves the EMA or the raw
parameters of a training checkpoint.
"""

import hashlib
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import glsdet_tpu.train.loop as jloop
import glsdet_tpu_torch.train.loop as tloop
from glsdet_tpu.config import apply_overrides as j_overrides
from glsdet_tpu.config import get_config as j_get_config
from glsdet_tpu.data import loader as jl
from glsdet_tpu_torch import apis
from glsdet_tpu_torch.config import apply_overrides, get_config
from glsdet_tpu_torch.train import schedules
from glsdet_tpu_torch.train.state import state_dict

from torch_port_util import write_png_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_png_dataset(str(tmp_path_factory.mktemp("ds")))


def digest(batch) -> str:
    h = hashlib.sha1()
    for k in sorted(batch):
        v = np.asarray(batch[k].numpy() if torch.is_tensor(batch[k])
                       else batch[k])
        h.update(f"{k}{v.dtype}{v.shape}".encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


class TinyJax(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Dense(3, name="backbone")(x.mean(axis=(1, 2)))
        return fnn.Dense(2, name="head")(x)


class TinyTorch(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = torch.nn.Linear(3, 3)
        self.head = torch.nn.Linear(3, 2)


def sync_train_loader(pipeline, batch_size, seed=0, num_threads=4,
                      prefetch=4, sampler=None):
    """The JAX package's ``train_loader`` stream without its producer
    thread: the same schedule and seeds, each batch built on demand."""
    n = len(pipeline.ds)
    epoch = 0
    master = np.random.RandomState(seed)
    while True:
        if getattr(sampler, "infinite", False):
            schedule = sampler
        elif sampler is not None:
            schedule = sampler.epoch_batches(epoch)
        else:
            order = master.permutation(n)
            schedule = [order[s:s + batch_size]
                        for s in range(0, n - batch_size + 1, batch_size)]
        for idxs in schedule:
            seeds = master.randint(0, 2 ** 31, size=batch_size)
            yield jl.make_batch([pipeline(int(i), np.random.RandomState(s))
                                 for i, s in zip(idxs, seeds)])
        epoch += 1


class Recorder:
    def __init__(self):
        self.events = []
        self.steps = 0

    def kind(self, family, img_hw, use_l1=None, strides=None,
             resize_from=None):
        return (family, tuple(img_hw), use_l1,
                None if strides is None else tuple(strides),
                None if resize_from is None else tuple(resize_from))

    def step(self, kind, batch):
        self.steps += 1
        self.events.append(("step", self.steps, kind, digest(batch)))
        return 1.0 + 0.01 * self.steps


def patch_jax(monkeypatch, rec):
    def yolox(model, tx, img_hw, use_l1=False, strides=(8, 16, 32),
              normalize=False, resize_from=None, bbox_loss_mode="square"):
        kind = rec.kind("yolox", img_hw, use_l1, strides, resize_from)
        return lambda state, batch: stepped(kind, state, batch)

    def mpdet(model, tx, img_hw, num_classes, proxies_list, reg_max=16,
              gamma=10.0, normalize=False):
        kind = rec.kind("mpdet", img_hw)
        return lambda state, batch: stepped(kind, state, batch)

    def gfl(model, tx, img_hw, num_classes, reg_max=16, normalize=False):
        kind = rec.kind("gfl", img_hw)
        return lambda state, batch: stepped(kind, state, batch)

    def stepped(kind, state, batch):
        loss = rec.step(kind, batch)
        return (state.replace(step=state.step + 1),
                {"loss": jnp.float32(loss), "aux": jnp.float32(2 * loss)})

    def update_ot(b, key, proxies):
        rec.events.append(("ot", rec.steps))
        return b

    def enable_emd(b):
        rec.events.append(("beta", rec.steps))
        return b._replace(beta=jnp.ones((), jnp.float32))

    def save(work_dir, state, epoch, wait=True):
        rec.events.append(("ckpt", epoch, rec.steps))

    proxy = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                     if not k.startswith("__")})
    proxy.jit = lambda f, **kw: f
    for name, val in [("jax", proxy), ("build_model", lambda cfg: TinyJax()),
                      ("make_yolox_train_step", yolox),
                      ("make_mpdet_train_step", mpdet),
                      ("make_gfl_train_step", gfl), ("update_ot", update_ot),
                      ("enable_emd_training", enable_emd),
                      ("save_checkpoint", save),
                      ("train_loader", sync_train_loader)]:
        monkeypatch.setattr(jloop, name, val)
    monkeypatch.setattr(jloop, "make_scan_train_step", scan_steps)


def scan_steps(step_fn):
    """``make_scan_train_step`` with ``lax.scan`` unrolled: the stubs
    record each step of a group."""
    def group(state, stacked):
        per_step = []
        for i in range(len(next(iter(stacked.values())))):
            state, m = step_fn(state, {k: v[i] for k, v in stacked.items()})
            per_step.append(m)
        return state, {k: jnp.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    return group


def patch_port(monkeypatch, rec):
    def yolox(model, img_hw, use_l1=False, strides=(8, 16, 32),
              normalize=False, resize_from=None, bbox_loss_mode="square",
              dtype=torch.float32):
        kind = rec.kind("yolox", img_hw, use_l1, strides, resize_from)
        return lambda state, batch: stepped(kind, state, batch)

    def mpdet(model, img_hw, num_classes, proxies_list, reg_max=16,
              gamma=10.0, normalize=False, dtype=torch.float32):
        kind = rec.kind("mpdet", img_hw)
        return lambda state, batch: stepped(kind, state, batch)

    def gfl(model, img_hw, num_classes, reg_max=16, normalize=False,
            dtype=torch.float32):
        kind = rec.kind("gfl", img_hw)
        return lambda state, batch: stepped(kind, state, batch)

    def stepped(kind, state, batch):
        loss = rec.step(kind, batch)
        state.step += 1
        return state, {"loss": torch.tensor(loss, dtype=torch.float32),
                       "aux": torch.tensor(2 * loss, dtype=torch.float32)}

    def update_ot(b, gen, proxies):
        rec.events.append(("ot", rec.steps))
        return b

    def enable_emd(b):
        rec.events.append(("beta", rec.steps))
        return b._replace(beta=torch.ones_like(b.beta))

    def save(work_dir, state, epoch, wait=True):
        rec.events.append(("ckpt", epoch, rec.steps))

    for name, val in [("build_model", lambda cfg, dev, generator: TinyTorch()),
                      ("make_yolox_train_step", yolox),
                      ("make_mpdet_train_step", mpdet),
                      ("make_gfl_train_step", gfl), ("update_ot", update_ot),
                      ("enable_emd_training", enable_emd),
                      ("save_checkpoint", save)]:
        monkeypatch.setattr(tloop, name, val)


BASE = {"data.img_hw": (64, 64), "data.batch_size": 2, "data.max_gt": 20,
        "data.num_workers": 0, "train.log_interval": 1,
        "train.ckpt_interval": 1}
RECIPES = {
    "default": ("coarse_det", {"train.epochs": 3,
                               "train.num_last_epochs": 1,
                               "train.log_interval": 3}),
    "mpdet_ot": ("mp_det_res50", {"train.epochs": 4, "train.ot_interval": 3,
                                  "train.emd_start_epoch": 1,
                                  "train.ot_stop_epoch": 3,
                                  "train.ckpt_interval": 2}),
    "gfl": ("gfl_res50", {"train.epochs": 2}),
    "freeze": ("coarse_det", {"train.epochs": 3, "train.freeze_epochs": 1,
                              "train.freeze_batch_size": 4,
                              "train.freeze_lr": 0.005,
                              "train.num_last_epochs": 1}),
    "iter_based": ("coarse_det", {"train.max_iters": 7, "train.epochs": 2}),
    "multiscale": ("coarse_det", {"train.epochs": 2,
                                  "train.num_last_epochs": 1,
                                  "train.multiscale_sizes": (32, 64, 96),
                                  "train.multiscale_interval": 1}),
    "groups": ("mp_det_res50", {"train.epochs": 3, "train.steps_per_call": 3,
                                "train.ot_interval": 3,
                                "train.log_interval": 3,
                                "train.emd_start_epoch": 1,
                                "train.ot_stop_epoch": 3}),
    "groups_switch": ("coarse_det", {"train.epochs": 3,
                                     "train.num_last_epochs": 1,
                                     "train.steps_per_call": 2,
                                     "train.log_interval": 2}),
}


def run_loop(pkg, monkeypatch, tmp_path, dataset, name, over, max_steps):
    rec = Recorder()
    work = str(tmp_path / pkg)
    opts = {**BASE, **over, "train.work_dir": work,
            "data.ann_file": dataset[0], "data.img_root": dataset[1]}

    def eval_fn(state, epoch):
        rec.events.append(("eval", epoch, rec.steps))

    with monkeypatch.context() as m:
        if pkg == "jax":
            patch_jax(m, rec)
            cfg = j_overrides(j_get_config(name), opts)
            jloop.train(cfg, max_steps=max_steps, eval_fn=eval_fn)
        else:
            patch_port(m, rec)
            cfg = apply_overrides(get_config(name), opts)
            tloop.train(cfg, max_steps=max_steps, eval_fn=eval_fn,
                        device="cpu")
    log = []
    if os.path.exists(os.path.join(work, "train.log.json")):
        with open(os.path.join(work, "train.log.json")) as f:
            log = [json.loads(line) for line in f]
    for entry in log:
        del entry["time"]
    return rec.events, log


@pytest.mark.parametrize("recipe,max_steps", [
    ("default", None), ("mpdet_ot", None), ("gfl", None), ("freeze", None),
    ("freeze", 3), ("iter_based", None), ("multiscale", None),
    ("groups", None), ("groups", 5), ("groups_switch", None)])
def test_stubbed_train_events_equal_jax(monkeypatch, tmp_path, dataset,
                                        recipe, max_steps):
    name, over = RECIPES[recipe]
    want = run_loop("jax", monkeypatch, tmp_path, dataset, name, over,
                    max_steps)
    got = run_loop("port", monkeypatch, tmp_path, dataset, name, over,
                   max_steps)
    assert got == want
    steps = [e for e in want[0] if e[0] == "step"]
    assert steps and want[1]
    if recipe == "default":                  # the mode switch happened
        assert {e[2][2] for e in steps} == {False, True}
    if recipe in ("mpdet_ot", "groups"):
        assert [e for e in want[0] if e[0] in ("ot", "beta")]
    if recipe == "groups_switch":
        assert {e[2][2] for e in steps} == {False, True}
    if recipe == "groups" and max_steps is None:
        # epochs of 4: a group of 3, then a single step; a hook fires
        # where the count crosses a multiple of 3 (single steps: 3, 6, ...)
        assert [e["step"] for e in want[1]] == [3, 7, 11, 12]
    if recipe == "multiscale":
        sizes = [e[2][1][0] for e in steps]
        assert sizes == [tloop.multiscale_size(i, (32, 64, 96), 1)
                         for i in range(len(steps))]
        assert len(set(sizes)) > 1


def test_multiscale_size_equals_jax():
    from glsdet_tpu.parallel.mesh import multiscale_size as j_size

    sizes = (608, 640, 672)
    for step in range(0, 400, 7):
        for interval in (1, 10):
            assert tloop.multiscale_size(step, sizes, interval) == j_size(
                step, sizes, interval)


def cfg_for(name, tmp_path, dataset, **over):
    small = {"coarse_det": {"model.phi": "nano"},
             "yolox_ffa": {"model.phi": "nano"},
             "mp_det_res50": {"model.depth": 18, "model.feat_channels": 64,
                              "model.num_words": 16}}[name]
    return apply_overrides(get_config(name), {
        **BASE, **small, "model.dtype": "float32", "data.batch_size": 4,
        "data.ann_file": dataset[0], "data.img_root": dataset[1],
        "train.work_dir": str(tmp_path), **over})


def snapshot(state):
    sd = state_dict(state)
    sd["generator"] = sd["generator"].clone()
    return sd


def assert_same_state(a, b):
    assert a["step"] == b["step"]
    assert torch.equal(a["generator"], b["generator"])
    for sec in ("model", "ema_params"):
        assert a[sec].keys() == b[sec].keys()
        for k in a[sec]:
            assert torch.equal(a[sec][k], b[sec][k]), (sec, k)
    assert a["optimizer"]["count"] == b["optimizer"]["count"]
    for k, st in a["optimizer"]["state"].items():
        for n, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                b["optimizer"]["state"][k][n])), (k, n)
    if a["boiw"] is not None:
        for k in a["boiw"]:
            assert torch.equal(a["boiw"][k], b["boiw"][k]), k


@pytest.mark.parametrize("name", ["coarse_det", "mp_det_res50"])
def test_real_train_checkpoint_and_resume(tmp_path, dataset, name):
    """8 frames at batch 4: 2 steps an epoch, 2 epochs, a checkpoint after
    each; the epoch-1 checkpoint restores the state eval_fn saw then, bit
    for bit, and a resumed run takes only epoch 2's steps."""
    over = {"train.epochs": 2, "train.num_last_epochs": 1,
            "train.ot_interval": 1, "train.emd_start_epoch": 1}
    cfg = cfg_for(name, tmp_path / "a", dataset, **over)
    seen = {}
    logs = []

    def eval_fn(state, epoch):
        seen[epoch] = snapshot(state)

    state = tloop.train(cfg, eval_fn=eval_fn, device="cpu")
    assert state.step == 4
    with open(tmp_path / "a" / "train.log.json") as f:
        logs = [json.loads(line) for line in f]
    assert len(logs) == 4 and all(np.isfinite(e["loss"]) for e in logs)
    if name == "coarse_det":
        assert logs[0]["loss_l1"] == 0.0 and logs[-1]["loss_l1"] > 0.0
    ckpt = str(tmp_path / "a" / "epoch_1.pt")
    fresh = cfg_for(name, tmp_path / "b", dataset, **over)
    restored = tloop.restore_checkpoint(ckpt, _fresh_state(fresh))
    assert_same_state(snapshot(restored), seen[1])
    if name == "mp_det_res50":
        assert float(seen[2]["boiw"]["beta"]) == 1.0
        assert float(seen[1]["boiw"]["beta"]) == 0.0

    resumed = cfg_for(name, tmp_path / "c", dataset, **over,
                      **{"train.resume": ckpt,
                         "train.load_from": str(tmp_path / "none.pt")})
    steps = []
    state = tloop.train(resumed, eval_fn=lambda s, e: steps.append(
        (e, s.step)), device="cpu")
    assert steps == [(2, 4)]


def _fresh_state(cfg):
    model = tloop.build_model(cfg, "cpu",
                              generator=torch.Generator().manual_seed(7))
    opt = tloop.build_optimizer(cfg, 2, model)
    return tloop.make_state_template(cfg, model, opt,
                                     torch.Generator().manual_seed(7))


def test_freeze_phase_leaves_frozen_parameters_unchanged(tmp_path, dataset):
    cfg = cfg_for("coarse_det", tmp_path, dataset, **{
        "train.epochs": 2, "train.freeze_epochs": 1,
        "train.num_last_epochs": 0})
    init = {k: v.clone() for k, v in tloop.build_model(
        cfg, "cpu", generator=torch.Generator().manual_seed(0)
    ).state_dict().items()}
    state = tloop.train(cfg, max_steps=2, device="cpu")
    after = state.model.state_dict()
    frozen = [k for k in init if k.startswith("backbone.")]
    weights = [k for k in frozen if "running" not in k
               and "num_batches" not in k]
    assert weights and all(torch.equal(after[k], init[k]) for k in weights)
    assert any(not torch.equal(after[k], init[k]) for k in frozen
               if "running_mean" in k)
    assert any(not torch.equal(after[k], init[k]) for k in after
               if k.startswith("head.") and "running" not in k)


def test_load_weights_skips_mismatched_shapes(tmp_path, dataset):
    cfg = cfg_for("coarse_det", tmp_path, dataset)
    src = _fresh_state(cfg)
    path = tloop.save_checkpoint(str(tmp_path), src, 1)
    other = apply_overrides(cfg_for("coarse_det", tmp_path, dataset),
                            {"model.num_classes": 3})
    dst = _fresh_state(other)
    dst, n_loaded, skipped = tloop.load_weights(path, dst)
    assert n_loaded > 0 and skipped
    assert all("shape" in why for _, why in skipped)
    assert {k.split("/")[0] for k, _ in skipped} == {"model", "ema_params"}
    sd = dst.model.state_dict()
    for k, v in src.model.state_dict().items():
        if sd[k].shape == v.shape:
            assert torch.equal(sd[k], v), k
    # a bare state-dict file seeds the EMA from its parameters
    torch.save(src.model.state_dict(), tmp_path / "bare.pt")
    dst = _fresh_state(cfg)
    dst, n_bare, skipped = tloop.load_weights(str(tmp_path / "bare.pt"), dst)
    assert not skipped
    for k, v in src.model.named_parameters():
        assert torch.equal(dst.ema_params[k], v)


def test_init_detector_serves_ema_or_raw_parameters(tmp_path, dataset):
    options = {"model.phi": "nano", "data.img_hw": (64, 64)}
    cfg = cfg_for("coarse_det", tmp_path, dataset, **{"train.epochs": 1})
    state = tloop.train(cfg, max_steps=1, device="cpu")
    path = tloop.save_checkpoint(str(tmp_path), state, 1)
    raw = dict(state.model.named_parameters())
    out = {}
    for use_ema in (True, False):
        _, model, _ = apis.init_detector("coarse_det", path, use_ema=use_ema,
                                         options=options, device="cpu")
        out[use_ema] = dict(model.named_parameters())
        assert not model.training
    differ = 0
    for k, p in raw.items():
        assert torch.equal(out[True][k], state.ema_params[k]), k
        assert torch.equal(out[False][k], p), k
        differ += not torch.equal(out[True][k], out[False][k])
    assert differ > 0
    for k, v in state.model.state_dict().items():
        if "running" in k:
            assert torch.equal(
                dict(apis.init_detector("coarse_det", path, options=options,
                                        device="cpu")[1].state_dict())[k], v)
            break
    # a plain state-dict file still loads strictly; nothing matching raises
    torch.save(state.model.state_dict(), tmp_path / "sd.pt")
    apis.init_detector("coarse_det", str(tmp_path / "sd.pt"),
                       options=options, device="cpu")
    torch.save({"model": {"x": torch.zeros(1)}, "step": 0},
               tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="no weight arrays"):
        apis.init_detector("coarse_det", str(tmp_path / "bad.pt"),
                           options=options, device="cpu")


@pytest.mark.parametrize("over,err", [
    ({"train.steps_per_call": 2, "train.log_interval": 2,
      "train.ot_interval": 2}, None),
    ({"train.steps_per_call": 2}, ValueError),
    ({"train.multiscale_sizes": (33,)}, ValueError),
    ({"train.freeze_epochs": 1, "train.max_iters": 5}, ValueError),
    ({"train.freeze_epochs": 2, "train.epochs": 2}, ValueError),
    ({"train.freeze_epochs": 1, "train.epochs": 2, "train.resume": "x"},
     ValueError),
])
def test_unsupported_and_invalid_recipes_raise(tmp_path, dataset, over, err):
    """Invalid recipes raise the JAX loop's errors; groups of steps with
    aligned intervals (``err`` None) train."""
    cfg = cfg_for("coarse_det", tmp_path, dataset, **over)
    if err is None:
        assert tloop.train(cfg, max_steps=2, device="cpu").step == 2
        return
    with pytest.raises(err):
        tloop.train(cfg, device="cpu")


def test_variant_families_and_the_card_without_gpu(tmp_path, dataset):
    """yolox_ffa (the 4-level FFA model, the adam_step recipe) trains a
    step on the CPU; without a card the default device raises."""
    cfg = cfg_for("yolox_ffa", tmp_path, dataset, **{"train.epochs": 1})
    state = tloop.train(cfg, max_steps=1, device="cpu")
    assert state.step == 1
    assert isinstance(state.optimizer, schedules.ScheduledAdam)
    with open(tmp_path / "train.log.json") as f:
        logs = [json.loads(line) for line in f]
    assert len(logs) == 1 and np.isfinite(logs[0]["loss"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            tloop.train(cfg_for("coarse_det", tmp_path, dataset))
