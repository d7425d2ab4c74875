"""``glsdet_tpu_torch.tools.train`` against the JAX package's
``tools/train.py``: both CLIs' ``train`` are stubbed and the ``Config``
each hands it must be equal, field for field, for the same arguments
(flags, ``--cfg-options``, ``--val-ann``), with the same truncation.
Then one real CPU run of the port (YOLOX-nano at 64x64, 4 frames at
batch 2: one epoch of 2 steps, with the per-epoch eval) writes
``epoch_1.pt``, which ``tools.test`` reads.  Several processes
(``--dist-*``, or ``GLSDET_*`` / SLURM's environment) make the command
join their group before ``train()`` runs."""

import dataclasses
import os

import pytest

import glsdet_tpu.train.loop  # noqa: F401  (patched by name)
import glsdet_tpu_torch.train.loop as tloop
from glsdet_tpu_torch.parallel import mesh
from glsdet_tpu_torch.tools import test as test_tool
from glsdet_tpu_torch.tools import train as tool
from torch_port_util import write_png_dataset
from torch_tools_util import COARSE_CLI, run_jax, write_set


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, cfg, max_steps=None, eval_fn=None, **kw):
        self.calls.append((dataclasses.asdict(cfg), max_steps,
                           eval_fn is not None, kw))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_png_dataset(str(tmp_path_factory.mktemp("train_ds")))


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    return write_set(str(tmp_path_factory.mktemp("val")),
                     [(60, 80), (40, 64)])


ARGVS = {
    "bare": ["coarse_det"],
    "flags": ["coarse_det", "--work-dir", "wd", "--resume", "r.pt",
              "--load-from", "l.pt", "--seed", "7", "--max-steps", "3"],
    "options": ["mp_det_res50", "--cfg-options", "train.base_lr=0.02",
                "data.img_hw=(512,512)", "model.depth=18",
                "train.work_dir=elsewhere"],
    "val": ["yolox_ffa", "--cfg-options", "model.phi=nano"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_argv_makes_the_jax_cli_config(name, dataset, val_set):
    argv = list(ARGVS[name])
    argv[1:1] = ["--ann", dataset[0], "--img-root", dataset[1]]
    if name == "val":
        argv += ["--val-ann", val_set[0]]
    jrec, trec = _Recorder(), _Recorder()
    run_jax("train", argv, **{"glsdet_tpu.train.loop:train": jrec})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop, "train", trec)
        tool.main([*argv, "--device", "cpu"])
    (jcfg, jsteps, jeval, _), = jrec.calls
    (tcfg, tsteps, teval, kw), = trec.calls
    assert tcfg == jcfg and tsteps == jsteps and teval == jeval
    assert kw == {"device": "cpu"}
    assert jcfg["data"]["ann_file"] == dataset[0]
    if name == "val":
        assert jeval and jcfg["data"]["val_img_root"] == dataset[1]


def test_a_real_run_writes_what_test_reads(tmp_path, dataset, val_set,
                                           capsys):
    ann, img_root = dataset
    work = str(tmp_path / "work")
    state = tool.main([
        "coarse_det", "--ann", ann, "--img-root", img_root, "--work-dir",
        work, "--val-ann", val_set[0], "--val-img-root", val_set[1],
        "--cfg-options", *COARSE_CLI, "model.num_classes=3",
        "data.batch_size=4", "data.num_workers=0", "train.epochs=1",
        "train.warmup_epochs=0", "train.num_last_epochs=0",
        "--device", "cpu"])
    assert state.step == 2
    assert "epoch 1: AP=" in capsys.readouterr().out
    ckpt = os.path.join(work, "epoch_1.pt")
    assert os.path.exists(ckpt)
    res, stats = test_tool.main([
        "coarse_det", "--ckpt", ckpt, "--ann", ann, "--img-root", img_root,
        "--use-ema", "--cfg-options", *COARSE_CLI, "model.num_classes=3",
        "--device", "cpu"])
    assert stats["images"] == 8 and -1.0 <= res.ap <= 1.0


@pytest.mark.parametrize("how", ["flag", "GLSDET_NUM_PROCESSES",
                                 "SLURM_NTASKS"])
def test_several_processes_raise(how, dataset, monkeypatch):
    """Several processes, configured by the flags, ``GLSDET_*`` or
    SLURM's environment: the command joins the group as the rank they
    name on ``--device`` before ``train()`` runs (the group itself is
    recorded here; two real ranks: ``test_torch_dist_loop.py``)."""
    for k in ("GLSDET_COORDINATOR", "GLSDET_NUM_PROCESSES",
              "GLSDET_PROCESS_ID", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    argv = ["coarse_det", "--ann", dataset[0], "--img-root", dataset[1],
            "--device", "cpu"]
    if how == "flag":
        argv += ["--dist-coordinator", "h:1234", "--dist-num-processes",
                 "2", "--dist-process-id", "1"]
    else:
        monkeypatch.setenv("GLSDET_COORDINATOR", "h:1234")
        prefix = "GLSDET" if how.startswith("GLSDET") else "SLURM"
        monkeypatch.setenv(how, "2")
        monkeypatch.setenv("GLSDET_PROCESS_ID" if prefix == "GLSDET"
                           else "SLURM_PROCID", "1")
    joins = []
    monkeypatch.setattr(mesh, "init_distributed",
                        lambda *a, **kw: joins.append((a, kw)))
    monkeypatch.setattr(tloop, "train", _Recorder())
    tool.main(argv)
    assert joins == [(("h:1234", 2, 1), {"device": "cpu", "backend": None})]
    assert len(tloop.train.calls) == 1
