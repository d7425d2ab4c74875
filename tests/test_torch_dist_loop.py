"""The port's data parallelism above the step: ``parallel/mesh.py``'s
group set-up and helpers in one process, then two ranks of
``tests/torch_dist_worker.py`` (gloo on the CPU) running ``train()`` and
``run_eval(mesh=)``, and the ``train`` / ``test`` commands launched
across two processes by ``tools/dist_launch.py``.

- ``maybe_init_distributed`` resolves each field as the JAX package's:
  the argument, then ``GLSDET_*``, then SLURM's; nothing set joins
  nothing.  ``init_distributed`` refuses a group it cannot form, and a
  rank that asks for a card without one.
- ``shard_batch``: rank r of W takes rows [r B / W, (r + 1) B / W).
- ``train()`` of YOLOX-nano at 64x64 on 8 PNG frames, global batch 4,
  one epoch of 2 steps: the ranks end with equal states, rank 0 alone
  writes the checkpoint, which holds that state, and the log.
- ``run_eval(mesh=data_mesh())`` over 7 frames at global batch 4 (the
  last batch padded) against the JAX ``run_eval(mesh=data_mesh(2))`` on
  the same flax weights, their BatchNorm statistics calibrated on the
  frames (``torch_tools_util.calibrate_batch_stats``: seeded statistics
  leave every frame's best anchors tied, and COCO's ranking breaks ties
  either way): the COCO stats within 1e-3, as ``tools.test``'s tests
  hold them; both ranks score the same set, equal to the port's
  one-process ``run_eval``'s.
- ``dist_launch train`` and ``dist_launch test`` (2 processes each,
  ``--device cpu``, at the same time; the test on the checkpoint of the
  ranks' ``train()`` above, whose options are the train command's; the
  train command's with ``train.steps_per_call=2`` added, so that its
  epoch runs as one group of two steps): both exit 0, the checkpoint and
  the log are written once, the group's checkpoint holds the ranks'
  single steps' weights within 1e-6 of each leaf's max, and the test's
  ``--out`` (written by rank 0) equals one process's.
"""

import concurrent.futures
import json
import os

import numpy as np
import pytest
import torch

from glsdet_tpu.data.coco import CocoDataset as JDataset
from glsdet_tpu.eval import runner as jrunner
from glsdet_tpu.models import YOLOXDetector as JYOLOX
from glsdet_tpu.parallel import data_mesh as j_data_mesh
from glsdet_tpu_torch.data.coco import CocoDataset as TDataset
from glsdet_tpu_torch.eval import runner as trunner
from glsdet_tpu_torch.models import YOLOXDetector
from glsdet_tpu_torch.parallel import mesh
from glsdet_tpu_torch.tools import dist_launch
from glsdet_tpu_torch.tools import test as test_tool
from glsdet_tpu_torch.utils.flax_import import state_dict_from_flax
import torch_dist_worker as W
from torch_port_util import assert_leaf_close, write_png_dataset
from torch_tools_util import (COARSE_CLI, calibrate_batch_stats, frame,
                              gts_from_dump, seeded_variables, write_set)

EVAL_FRAMES = [(96, 160), (80, 120), (64, 64), (100, 75), (90, 150),
               (120, 120), (72, 128)]
EVAL_KW = {"batch_size": 4, "score_thr": 1e-3, "nms_iou": 0.65,
           "max_dets": 100}
STATS_TOL = 1e-3
TRAIN_OPTS = ["model.phi=nano", "model.dtype=float32",
              "data.img_hw=(64,64)", "data.batch_size=4",
              "data.num_workers=0", "train.epochs=1",
              "train.warmup_epochs=0", "train.num_last_epochs=0",
              "train.log_interval=1"]
ENV = ("GLSDET_COORDINATOR", "GLSDET_NUM_PROCESSES", "GLSDET_PROCESS_ID",
       "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID")


class _Calls:
    def __init__(self):
        self.calls = []

    def __call__(self, *a, **kw):
        self.calls.append((a, kw))


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


CASES = {
    "nothing": ({}, {}, None),
    "arguments": ({}, {"coordinator_address": "h:1", "num_processes": 4,
                       "process_id": 2}, ("h:1", 4, 2)),
    "glsdet_env": ({"GLSDET_COORDINATOR": "h:2", "GLSDET_NUM_PROCESSES": "3",
                    "GLSDET_PROCESS_ID": "1"}, {}, ("h:2", 3, 1)),
    "slurm_env": ({"GLSDET_COORDINATOR": "h:3", "SLURM_NTASKS": "8",
                   "SLURM_PROCID": "5"}, {}, ("h:3", 8, 5)),
    "glsdet_over_slurm": ({"GLSDET_COORDINATOR": "h:4",
                           "GLSDET_NUM_PROCESSES": "2",
                           "GLSDET_PROCESS_ID": "0", "SLURM_NTASKS": "8",
                           "SLURM_PROCID": "5"}, {}, ("h:4", 2, 0)),
    "argument_over_env": ({"GLSDET_COORDINATOR": "h:5",
                           "GLSDET_NUM_PROCESSES": "3",
                           "GLSDET_PROCESS_ID": "2"},
                          {"coordinator_address": "h:6",
                           "process_id": 1}, ("h:6", 3, 1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_maybe_init_distributed_resolves_as_jax(case, clean_env):
    env, kw, want = CASES[case]
    for k, v in env.items():
        clean_env.setenv(k, v)
    calls = _Calls()
    clean_env.setattr(mesh, "init_distributed", calls)
    joined = mesh.maybe_init_distributed(device="cpu", **kw)
    assert joined == (want is not None)
    if want is None:
        assert calls.calls == []
    else:
        (args, kwargs), = calls.calls
        assert args == want and kwargs["device"] == "cpu"


def test_init_distributed_guards(clean_env):
    with pytest.raises(ValueError, match="coordinator"):
        mesh.init_distributed(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="id"):
        mesh.init_distributed("127.0.0.1:1", 2, None, device="cpu")
    with pytest.raises(ValueError, match="not in"):
        mesh.init_distributed("127.0.0.1:1", 2, 2, device="cpu")
    with pytest.raises(ValueError, match="host:port"):
        mesh.init_distributed("nowhere", 1, 0, device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        mesh.init_distributed("127.0.0.1:1", 1, 0, device="cpu",
                              backend="nccl")
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        mesh.init_distributed("127.0.0.1:1", 1, 0)
    assert not mesh.active()


def test_one_process_group_in_process():
    """A group of one (gloo) joins, gives its mesh, and leaves."""
    m = mesh.init_distributed(f"127.0.0.1:{dist_launch.free_port()}", 1,
                              device="cpu")
    try:
        assert mesh.active() and m == mesh.data_mesh()
        assert (m.world_size, m.rank, m.device.type) == (1, 0, "cpu")
        x = torch.arange(4.0)
        assert torch.equal(mesh.all_sum(x), x)
    finally:
        mesh.shutdown()
    assert not mesh.active()


def test_shard_batch_takes_this_ranks_rows():
    batch = {"a": np.arange(8), "b": torch.arange(16).reshape(8, 2)}
    for r in range(4):
        got = mesh.shard_batch(batch, mesh.DataMesh(4, r, "cpu"))
        np.testing.assert_array_equal(got["a"], [2 * r, 2 * r + 1])
        assert torch.equal(got["b"], batch["b"][2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="divisible"):
        mesh.shard_batch(batch, mesh.DataMesh(3, 0, "cpu"))


def test_helpers_without_a_group_are_the_identity():
    assert not mesh.active()
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_sum(x) is x
    assert torch.equal(mesh.all_gather(x), x[None])
    idx = torch.tensor([[2, 0], [1, 1]])
    assert torch.equal(mesh.gather_rows(x, idx), x[idx])
    metrics = {"loss": torch.tensor(1.0)}
    assert mesh.reduce_metrics(metrics) is metrics
    net = torch.nn.Linear(2, 2)
    assert mesh.replicate(net) is net
    m = mesh.data_mesh("cpu")
    assert (m.world_size, m.rank, m.group) == (1, 0, None)


def test_loaded_momentum_does_not_alias_the_checkpoint():
    """``load_state_dict`` of a checkpoint in the JAX form (the momentum
    trace by name) copies the trace: a step updates the optimizer's
    buffers, not the checkpoint (the two-rank step tests load one
    checkpoint for several runs)."""
    from glsdet_tpu_torch.train.state import load_state_dict, state_dict

    state, _ = W.family_state("gfl", torch.float32)
    sd = state_dict(state)
    named = dict(state.model.named_parameters())
    trace = {n: torch.randn(p.shape, generator=torch.Generator()
                            .manual_seed(1)) for n, p in named.items()}
    ckpt = dict(sd, generator=None,
                optimizer={"momentum": trace, "count": 0})
    before = {n: t.clone() for n, t in trace.items()}
    load_state_dict(state, ckpt)
    for p in named.values():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    for n, t in trace.items():
        assert torch.equal(t, before[n]), n
        assert not torch.equal(
            state.optimizer.state[named[n]]["momentum_buffer"], t), n


# ── two ranks ──────────────────────────────────────────────────────────

@pytest.fixture(scope="module")
def eval_case(tmp_path_factory):
    """Calibrated flax weights of YOLOX-nano, the port's model on them,
    and a 7-frame set whose ground truth is the port's own detections
    (jittered, every third dropped)."""
    root = str(tmp_path_factory.mktemp("dist_eval"))
    jm = JYOLOX(num_classes=W.NC, phi="nano")
    v = seeded_variables(jm, (64, 64), seed=11)
    from glsdet_tpu.data.augment import letterbox

    frames = np.stack([letterbox(frame(i, hw), np.zeros((0, 4)),
                                 (64, 64))[0]
                       for i, hw in enumerate(EVAL_FRAMES)])
    v = calibrate_batch_stats(jm, v, frames)
    tm = YOLOXDetector(W.NC, "nano",
                       generator=torch.Generator().manual_seed(0)).eval()
    tm.load_state_dict(state_dict_from_flax(v))
    ann, img_root = write_set(root, EVAL_FRAMES, name="bare.json")
    dump = os.path.join(root, "bare.dets.json")
    trunner.run_eval(TDataset(ann, img_root), tm, "yolox", (64, 64), W.NC,
                     out_json=dump, format_only=True, verbose=False,
                     device="cpu", **EVAL_KW)
    ann, img_root = write_set(root, EVAL_FRAMES, gts=gts_from_dump(dump, 0))
    return jm, v, tm, ann, img_root


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, eval_case):
    """Two ranks running ``train()`` and ``run_eval(mesh=)``, and the
    latter's references."""
    d = str(tmp_path_factory.mktemp("dist_loop"))
    _, _, tm, ann, img_root = eval_case
    torch.save(tm.state_dict(), os.path.join(d, "eval_model.pt"))
    t_ann, t_root = write_png_dataset(os.path.join(d, "train_ds"))
    work = os.path.join(d, "work")
    opts = [*TRAIN_OPTS, f"data.ann_file={t_ann}",
            f"data.img_root={t_root}", f"train.work_dir={work}"]
    wait = W.launch({"parts": ["train", "eval"],
                     "train_cfg": ["coarse_det", opts],
                     "eval_set": [ann, img_root], "eval_hw": [64, 64],
                     "eval_kw": EVAL_KW}, d)
    try:
        # the references of run_eval(mesh=), while the ranks run: the JAX
        # run_eval(mesh=data_mesh(2)) and the port's in one process
        jm, v = eval_case[:2]
        out = {"d": d, "work": work, "jax": jrunner.run_eval(
            JDataset(ann, img_root), lambda w, x: jm.apply(w, x, train=False),
            "yolox", (64, 64), W.NC, variables=v, mesh=j_data_mesh(2),
            verbose=False, **EVAL_KW)}
        out["one"], _ = trunner.run_eval(TDataset(ann, img_root), tm,
                                         "yolox", (64, 64), W.NC,
                                         verbose=False, device="cpu",
                                         **EVAL_KW)
    finally:
        wait()
    out["train"] = [dict(np.load(os.path.join(d, f"train_r{r}.npz")))
                    for r in range(2)]
    out["eval"] = []
    for r in range(2):
        with open(os.path.join(d, f"eval_r{r}.json")) as f:
            out["eval"].append(json.load(f))
    return out


def test_train_two_ranks(ranks):
    r0, r1 = ranks["train"]
    assert int(r0["step"]) == 2
    assert set(r0) == set(r1)
    for k in r0:
        if k != "saves":
            np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
    np.testing.assert_array_equal(r0["saves"], [1])
    assert r1["saves"].size == 0
    assert sorted(os.listdir(ranks["work"])) == ["epoch_1.pt",
                                                 "train.log.json"]
    with open(os.path.join(ranks["work"], "train.log.json")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    ckpt = torch.load(os.path.join(ranks["work"], "epoch_1.pt"),
                      weights_only=True)
    assert ckpt["step"] == 2
    for k, v in ckpt["model"].items():
        np.testing.assert_array_equal(v.numpy(), r0[f"model/{k}"], err_msg=k)


def test_run_eval_mesh_matches_jax(ranks, eval_case, monkeypatch):
    _, _, tm, ann, img_root = eval_case
    want, wstats = ranks["jax"]
    one = ranks["one"]
    assert want.ap > 0.1
    for r in ranks["eval"]:
        assert r["images"] == wstats["images"] == len(EVAL_FRAMES)
        np.testing.assert_allclose(r["stats"], want.stats, atol=STATS_TOL)
        np.testing.assert_allclose(r["stats"], one.stats, atol=STATS_TOL)
    assert ranks["eval"][0] == ranks["eval"][1]
    with open(os.path.join(ranks["d"], "dets_r0.json")) as f:
        d0 = json.load(f)
    with open(os.path.join(ranks["d"], "dets_r1.json")) as f:
        assert json.load(f) == d0
    with pytest.raises(TypeError, match="data_mesh"):
        trunner.run_eval(TDataset(ann, img_root), tm, "yolox", (64, 64),
                         W.NC, mesh=j_data_mesh(2), device="cpu")


def test_dist_launch_train_and_test(tmp_path, monkeypatch, ranks):
    """``dist_launch train`` and, at the same time, ``dist_launch test``
    of the checkpoint the ranks' ``train()`` wrote with the same options
    (and one process's ``tools.test`` of it, and a launch that fails)."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv("PYTHONPATH", W.ROOT)
    ann, img_root = write_png_dataset(str(tmp_path / "ds"))
    pool = concurrent.futures.ThreadPoolExecutor(3)
    # a failing rank ends the launch with its code (beside the others)
    failing = pool.submit(dist_launch.main, [
        "test", "coarse_det", "2", "--ann", ann, "--img-root", img_root,
        "--device", "cpu", "--ckpt", str(tmp_path / "missing.pt")])
    work = str(tmp_path / "work")
    # the launch trains its epoch as one group of the two steps
    opts = ["--cfg-options", *TRAIN_OPTS, "train.steps_per_call=2",
            "train.log_interval=2"]
    training = pool.submit(dist_launch.main, [
        "train", "coarse_det", "2", "--ann", ann, "--img-root", img_root,
        "--work-dir", work, "--device", "cpu", *opts])
    ckpt = os.path.join(ranks["work"], "epoch_1.pt")
    out = str(tmp_path / "dist.json")
    test_opts = ["--cfg-options", *COARSE_CLI, "eval.score_thr=0.001",
                 "data.batch_size=4"]
    # one process, while the ranks run
    one = str(tmp_path / "one.json")
    alone = pool.submit(test_tool.main, [
        "coarse_det", "--ckpt", ckpt, "--ann", ann, "--img-root", img_root,
        "--out", one, "--device", "cpu", *test_opts])
    assert dist_launch.main([
        "test", "coarse_det", "2", "--ckpt", ckpt, "--ann", ann,
        "--img-root", img_root, "--out", out, "--device", "cpu",
        *test_opts]) == 0
    alone.result()
    with open(out) as f, open(one) as g:
        assert json.load(f) == json.load(g)
    assert training.result() == 0
    assert sorted(os.listdir(work)) == ["epoch_1.pt", "train.log.json"]
    with open(os.path.join(work, "train.log.json")) as f:
        assert [json.loads(line)["step"] for line in f] == [2]
    # the group's state is the single steps' (the ranks' train())
    grouped = torch.load(os.path.join(work, "epoch_1.pt"), weights_only=True)
    single = torch.load(ckpt, weights_only=True)
    assert grouped["step"] == single["step"] == 2
    for k, v in single["model"].items():
        assert_leaf_close(grouped["model"][k], v, k, 1e-6)
    assert failing.result() != 0
    pool.shutdown()
