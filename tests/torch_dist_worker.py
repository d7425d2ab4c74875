"""One rank of the port's multi-process CPU tests.

    python tests/torch_dist_worker.py JOB_JSON

:func:`launch` starts ``nproc`` of these with ``GLSDET_COORDINATOR``,
``GLSDET_NUM_PROCESSES`` and ``GLSDET_PROCESS_ID`` set (as
``tools/dist_launch.py`` does); each joins a gloo group on the CPU
(``parallel/mesh.py: maybe_init_distributed``), runs the job's parts in
order and writes its results into the job's directory, named by part and
rank.  This module imports neither JAX nor the JAX package: the tests
hand it their fixtures as files (batches as ``.npz``, train states in
the port's checkpoint form).

Parts:

- ``steps``: one train step of each family in ``families`` and dtype in
  ``dtypes`` from ``{family}_state.pt`` on this rank's rows
  (``shard_batch``) of ``{family}_batch.npz`` -> ``step_{family}_
  {dtype}_r{rank}.npz`` (the metrics and the digest of the state after
  the step; rank 0 also the state, in float32), and MP-Det's float64
  step with its blocks checkpointed ->
  ``step_mpdet_remat_float64_r{rank}.npz``;
- ``collectives``: the mesh helpers on per-rank values ->
  ``collectives_r{rank}.npz``;
- ``train``: ``train()`` of ``train_cfg`` (a config name and its
  ``--cfg-options`` strings) with ``save_checkpoint`` counted ->
  ``train_r{rank}.npz``;
- ``eval``: ``run_eval(mesh=data_mesh())`` of a YOLOX model from
  ``eval_model.pt`` -> ``eval_r{rank}.json`` (stats and detections).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from glsdet_tpu_torch.models import GFLDet, MPDet, YOLOXDetector  # noqa: E402
from glsdet_tpu_torch.parallel import mesh  # noqa: E402
from glsdet_tpu_torch.train import schedules  # noqa: E402
from glsdet_tpu_torch.train.boiw import enable_emd_training, init_boiw  # noqa: E402
from glsdet_tpu_torch.train.state import (TrainState,  # noqa: E402
                                          load_state_dict, state_dict)
from glsdet_tpu_torch.train.steps import (make_gfl_train_step,  # noqa: E402
                                          make_mpdet_train_step,
                                          make_yolox_train_step)

# the families' fixtures: the sizes of test_torch_yolox_train.py,
# test_torch_gfl.py and test_torch_train_step.py
NC = 10
FAMILIES = {
    "yolox": {"hw": (64, 96), "g": 4},
    "gfl": {"hw": (128, 128), "g": 3},
    "mpdet": {"hw": (128, 128), "g": 3},
}
B = 2                               # the global batch: one image a rank
DEPTH, FC, WORDS = 18, 64, 16
PROXIES = (2, 3, 2, 5, 4, 8, 8, 4, 3, 3)
YOLOX_SCHED = dict(base_lr=0.01, warmup_steps=4, total_steps=20,
                   no_aug_steps=4)
SPE = 100                           # steps per epoch of schedule_1x
MP_CLIP = 0.5                       # binds on this fixture's gradient
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def family_state(family: str, dtype=torch.float32, remat: bool = False):
    """The port's model, optimizer and step of ``family`` in ``dtype``, as
    a fresh ``TrainState`` (seeded weights: a fixture overwrites them);
    ``remat`` checkpoints MP-Det's blocks."""
    gen = torch.Generator().manual_seed(0)
    hw = FAMILIES[family]["hw"]
    boiw = None
    if family == "yolox":
        model = YOLOXDetector(NC, "nano", generator=gen).to(dtype)
        opt = schedules.yolox_sgd(model.parameters(),
                                  schedules.yolox_warm_cos(**YOLOX_SCHED))
        step = make_yolox_train_step(model, img_hw=hw)
    elif family == "gfl":
        model = GFLDet(NC, DEPTH, FC, generator=gen).to(dtype)
        opt = schedules.mp_det_sgd(model.parameters(),
                                   schedules.schedule_1x(0.01, SPE))
        step = make_gfl_train_step(model, hw, NC)
    else:
        model = MPDet(NC, DEPTH, FC, PROXIES, remat=remat,
                      generator=gen).to(dtype)
        opt = schedules.mp_det_sgd(model.parameters(),
                                   schedules.schedule_1x(0.01, SPE),
                                   grad_clip=MP_CLIP)
        step = make_mpdet_train_step(model, hw, NC, PROXIES, normalize=True)
        boiw = enable_emd_training(init_boiw(gen, NC, WORDS, FC, PROXIES,
                                             device="cpu"))
    state = TrainState.create(model, opt, torch.Generator().manual_seed(0),
                              boiw=boiw)
    return state, step


def run_step(family: str, dtype, ckpt: dict, batch: dict, noise=None,
             remat: bool = False):
    """One step of ``family`` from the checkpoint ``ckpt`` on ``batch``
    (numpy arrays): the metrics (floats) and the state's arrays."""
    state, step = family_state(family, dtype, remat)
    load_state_dict(state, ckpt)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    kw = {} if noise is None else {"noise": torch.from_numpy(noise)}
    state, metrics = step(state, tb, **kw)
    return {k: float(v) for k, v in metrics.items()}, state_arrays(state)


def digest(arrays: dict) -> str:
    """sha256 of the arrays' bytes in key order: equal states, bit for
    bit, give equal digests."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def state_arrays(state) -> dict:
    """A train state as flat numpy arrays: ``model/``, ``ema/``,
    ``momentum/`` (by parameter name), ``boiw/``, ``step``, ``count``."""
    sd = state_dict(state)
    out = {f"model/{k}": v.numpy() for k, v in sd["model"].items()}
    out.update({f"ema/{k}": v.numpy() for k, v in sd["ema_params"].items()})
    names = {p: n for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        if st.get("momentum_buffer") is not None:
            out[f"momentum/{names[p]}"] = st["momentum_buffer"].numpy()
    for k, v in (sd["boiw"] or {}).items():
        out[f"boiw/{k}"] = v.numpy()
    out["step"] = np.int64(sd["step"])
    out["count"] = np.int64(sd["optimizer"]["count"])
    return out


# ── parts ──────────────────────────────────────────────────────────────

def part_steps(job: dict, d: str, rank: int) -> None:
    m = mesh.data_mesh()
    for family in job["families"]:
        ckpt = torch.load(os.path.join(d, f"{family}_state.pt"),
                          weights_only=True)
        with np.load(os.path.join(d, f"{family}_batch.npz")) as z:
            batch = mesh.shard_batch(dict(z), m)
        noise = None
        if family == "mpdet":
            noise = np.load(os.path.join(d, "mpdet_noise.npy"))
        runs = [(name, False) for name in job["dtypes"]]
        if family == "mpdet":
            runs.append(("float64", True))
        for name, remat in runs:
            metrics, arrays = run_step(family, DTYPES[name], ckpt, batch,
                                       noise, remat)
            tag = f"{family}{'_remat' if remat else ''}_{name}"
            # every rank's digest; rank 0's arrays (in float32, to keep
            # the files small: the tests' bounds are far above its ulp)
            out = {"digest": np.array(digest(arrays)),
                   **{f"metric/{k}": np.float64(v)
                      for k, v in metrics.items()}}
            if rank == 0:
                out.update({k: (v.astype(np.float32) if v.dtype.kind == "f"
                                else v) for k, v in arrays.items()})
            np.savez(os.path.join(d, f"step_{tag}_r{rank}.npz"), **out)


def part_collectives(job: dict, d: str, rank: int) -> None:
    """The helpers on rank-dependent values: a sum, a gather, rows of the
    ranks' concatenation with their gradients, a broadcast and a
    replicated module."""
    out = {}
    w = mesh.world_size()
    x = torch.arange(6, dtype=torch.float64).reshape(3, 2) + 10 * rank
    out["sum"] = mesh.all_sum(x).numpy()
    out["gather"] = mesh.all_gather(x).numpy()
    out["labels"] = mesh.all_gather(torch.tensor([rank, 7])).numpy()
    local = x.clone().requires_grad_(True)
    idx = torch.tensor([[3 * w - 1, 0], [1, 3]])
    rows = mesh.gather_rows(local, idx)
    (rows * torch.arange(1, 5, dtype=torch.float64).reshape(2, 2, 1)
     ).sum().backward()
    out["rows"] = rows.detach().numpy()
    out["rows_grad"] = local.grad.numpy()
    b = torch.full((4,), float(rank))
    mesh.broadcast_([b])
    out["broadcast"] = b.numpy()
    net = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(net.weight, float(rank))
    mesh.replicate(net)
    out["replicated"] = net.weight.detach().numpy()
    out["metrics"] = np.array([float(v) for v in mesh.reduce_metrics(
        {"a": torch.tensor(1.0 + rank), "n": torch.tensor(5.0)},
        replicated=("n",)).values()])
    np.savez(os.path.join(d, f"collectives_r{rank}.npz"), **out)


def part_train(job: dict, d: str, rank: int) -> None:
    from glsdet_tpu_torch.config import (apply_overrides, get_config,
                                         parse_cfg_options)
    from glsdet_tpu_torch.train import loop

    name, options = job["train_cfg"]
    cfg = get_config(name)
    apply_overrides(cfg, parse_cfg_options(options))
    saves = []
    save = loop.save_checkpoint

    def counted(*a, **kw):
        saves.append(a[2])
        return save(*a, **kw)

    loop.save_checkpoint = counted
    state = loop.train(cfg, device="cpu")
    loop.save_checkpoint = save
    np.savez(os.path.join(d, f"train_r{rank}.npz"), **state_arrays(state),
             saves=np.asarray(saves, np.int64))


def part_eval(job: dict, d: str, rank: int) -> None:
    from glsdet_tpu_torch.data.coco import CocoDataset
    from glsdet_tpu_torch.eval.runner import run_eval

    model = YOLOXDetector(NC, "nano",
                          generator=torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(torch.load(os.path.join(d, "eval_model.pt"),
                                     weights_only=True))
    ann, img_root = job["eval_set"]
    res, stats = run_eval(CocoDataset(ann, img_root), model, "yolox",
                          tuple(job["eval_hw"]), NC, mesh=mesh.data_mesh(),
                          out_json=os.path.join(d, f"dets_r{rank}.json"),
                          verbose=False, **job["eval_kw"])
    with open(os.path.join(d, f"eval_r{rank}.json"), "w") as f:
        json.dump({"stats": list(map(float, res.stats)),
                   "images": stats["images"]}, f)


PARTS = {"steps": part_steps, "collectives": part_collectives,
         "train": part_train, "eval": part_eval}


def main(job_path: str) -> None:
    torch.set_num_threads(2)
    with open(job_path) as f:
        job = json.load(f)
    d = os.path.dirname(os.path.abspath(job_path))
    assert mesh.maybe_init_distributed(device="cpu")
    try:
        for part in job["parts"]:
            PARTS[part](job, d, mesh.rank())
    finally:
        mesh.shutdown()


# ── the launcher the tests call ────────────────────────────────────────

def launch(job: dict, d: str, nproc: int = 2, timeout: float = 600):
    """Start ``nproc`` ranks of ``job`` (written to ``d/job.json``);
    returns ``wait()``, which raises with the ranks' output if one
    failed."""
    from glsdet_tpu_torch.tools.dist_launch import free_port

    path = os.path.join(d, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("GLSDET_", "SLURM_"))}
    env.update(GLSDET_COORDINATOR=f"127.0.0.1:{free_port()}",
               GLSDET_NUM_PROCESSES=str(nproc), PYTHONPATH=ROOT)
    procs = []
    for rank in range(nproc):
        log = open(os.path.join(d, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path],
            env=dict(env, GLSDET_PROCESS_ID=str(rank)), stdout=log,
            stderr=subprocess.STDOUT), log))
    start = time.monotonic()

    def wait():
        try:
            for p, _ in procs:
                p.wait(timeout=max(1.0, timeout - (time.monotonic()
                                                   - start)))
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        codes = [p.returncode for p, _ in procs]
        if any(codes):
            logs = []
            for rank in range(nproc):
                with open(os.path.join(d, f"rank{rank}.log")) as f:
                    logs.append(f"rank {rank}:\n" + f.read()[-3000:])
            raise RuntimeError(f"ranks exited {codes}\n" + "\n".join(logs))

    return wait


if __name__ == "__main__":
    main(sys.argv[1])
