"""Data parallelism across processes over ``torch.distributed``, the
counterpart of ``glsdet_tpu.parallel.mesh``.

The JAX package's data parallelism is global-view: one jitted step over a
batch sharded on a ``data`` mesh computes what one device computes on the
whole global batch.  Here each process (one per card: NCCL; or on the
CPU: gloo) holds a slice of the global batch, and the code that reduces
over the batch asks this module for the group's sums: BatchNorm's
statistics (``models/layers.py``), the losses' counts and normalisers,
the OT loss's and the dictionary update's rows (``train/``), the
gradients and the reported metrics (``train/steps.py``).  Every helper is
the identity when no process group is initialised, so a single process
runs as it always has.

Only a sum, a broadcast and a barrier are used, which NCCL and gloo (over
CPU tensors and over CUDA tensors) all have; a gather is a sum of
zero-filled buffers in which each rank fills its own slot.  Collectives
issued in the backward (BatchNorm's sums, a recomputed forward's) must
meet in the same order on every rank: every rank builds the same graph.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

# how long a rank waits in a collective: the other ranks wait at a
# barrier while rank 0 writes a checkpoint and runs an epoch's eval
TIMEOUT = datetime.timedelta(hours=1)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A data-parallel group: its size, this process's rank in it, the
    device this rank computes on and the process group (None for a
    process alone)."""
    world_size: int
    rank: int
    device: torch.device
    group: Optional[object] = None


# the group this process joined through init_distributed; like
# torch.distributed's default group, there is one per process
_joined: Optional[DataMesh] = None


def active() -> bool:
    """Whether this process is one rank of an initialised group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def local_device_index(process_id: int) -> int:
    """The card of process ``process_id`` on its host: ``SLURM_LOCALID``,
    else ``process_id`` modulo the host's card count."""
    env = os.environ.get("SLURM_LOCALID", "").strip()
    if env:
        return int(env)
    return process_id % torch.cuda.device_count()


def _card_identity(index: int) -> str:
    props = torch.cuda.get_device_properties(index)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}:{uuid if uuid is not None else index}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda", backend: Optional[str] = None) -> DataMesh:
    """Join the group of ``num_processes`` processes whose rank 0 listens
    at ``coordinator_address`` (``host:port``) as rank ``process_id``, and
    return its :func:`data_mesh`.

    ``device`` "cuda" (the default, as every entry point's) takes this
    rank's card, ``cuda:<local index>`` (:func:`local_device_index`), and
    the NCCL backend; "cpu" takes gloo.  ``backend`` overrides the
    choice; it exists so that two ranks can share one card over gloo.
    Two NCCL ranks on one card raise here, before NCCL would."""
    if coordinator_address is None or num_processes is None:
        raise ValueError(
            "a process group needs a coordinator address and a process "
            f"count (got {coordinator_address!r}, {num_processes!r}): set "
            "--dist-coordinator / GLSDET_COORDINATOR and "
            "--dist-num-processes / GLSDET_NUM_PROCESSES or SLURM_NTASKS")
    if process_id is None:
        if num_processes != 1:
            raise ValueError("a process group of several processes needs "
                             "each one's id (--dist-process-id / "
                             "GLSDET_PROCESS_ID or SLURM_PROCID)")
        process_id = 0
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} not in "
                         f"[0, {num_processes})")
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r} but no GPU is "
                               "available")
        index = local_device_index(process_id)
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"device {device!r}: expected cuda or cpu")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("the NCCL backend needs device='cuda'")

    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {coordinator_address!r}: "
                         "expected host:port")
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=TIMEOUT)
    if backend == "nccl":
        # NCCL makes its communicators at the first collective; two ranks
        # on one card fail there as "Duplicate GPU detected"
        me = _card_identity(dev.index)
        store.set(f"glsdet/card/{process_id}", me)
        for other in range(num_processes):
            if other != process_id and store.get(
                    f"glsdet/card/{other}").decode() == me:
                raise RuntimeError(
                    f"ranks {min(other, process_id)} and "
                    f"{max(other, process_id)} share one card ({me}): "
                    "NCCL needs a card per rank; run fewer processes, or "
                    "pass backend='gloo' to share it")
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=TIMEOUT)
    global _joined
    _joined = DataMesh(num_processes, process_id, dev, dist.group.WORLD)
    return _joined


def maybe_init_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> bool:
    """Join a process group when one is configured; no-op otherwise.

    Each field resolves as the JAX package's does: the explicit argument,
    then ``GLSDET_COORDINATOR`` / ``GLSDET_NUM_PROCESSES`` /
    ``GLSDET_PROCESS_ID`` (what ``tools/dist_launch.py`` sets), then
    SLURM's ``SLURM_NTASKS`` / ``SLURM_PROCID``; a count of 1 without a
    coordinator runs alone (a SLURM job of one task).  Returns True when a
    group was initialised (:func:`init_distributed` on ``device``, with
    the backend ``GLSDET_DIST_BACKEND`` names if it is set: what
    ``dist_launch --backend gloo`` sets for ranks sharing a card)."""
    coordinator_address = (coordinator_address
                           or os.environ.get("GLSDET_COORDINATOR"))
    if num_processes is None:
        env = os.environ.get("GLSDET_NUM_PROCESSES",
                             os.environ.get("SLURM_NTASKS"))
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("GLSDET_PROCESS_ID",
                             os.environ.get("SLURM_PROCID"))
        process_id = int(env) if env else None
    if coordinator_address is None and num_processes in (None, 1):
        return False
    init_distributed(coordinator_address, num_processes, process_id,
                     device=device,
                     backend=os.environ.get("GLSDET_DIST_BACKEND") or None)
    return True


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    global _joined
    if active():
        dist.destroy_process_group()
    _joined = None


def data_mesh(device=None) -> DataMesh:
    """The data-parallel group of this process: the group
    :func:`init_distributed` joined (on the device it chose), or without
    one a group of this process alone on ``device`` (default: the
    current card, else the CPU)."""
    if active():
        if _joined is not None:
            return _joined
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend() == "nccl"
                      else torch.device("cpu"))
    elif device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return DataMesh(world_size(), rank(), torch.device(device),
                    dist.group.WORLD if active() else None)


def _rows(mesh: DataMesh, n: int) -> slice:
    if n % mesh.world_size:
        raise ValueError(f"global batch {n} not divisible by "
                         f"{mesh.world_size} processes")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: Dict, mesh: DataMesh) -> Dict:
    """This rank's rows of a global batch (a dict of arrays or tensors
    with the batch on axis 0): rank r takes ``[r B / W, (r + 1) B / W)``,
    the row order of ``jax.make_array_from_process_local_data``."""
    return {k: v[_rows(mesh, len(v))] for k, v in batch.items()}


# ── collectives ─────────────────────────────────────────────────────────

def _through_card(t: torch.Tensor, op) -> torch.Tensor:
    """Run ``op`` in place on ``t``, over the rank's card when NCCL needs
    a CUDA tensor for a CPU one."""
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        on_card = t.to(torch.device("cuda", torch.cuda.current_device()))
        op(on_card)
        t.copy_(on_card)
    else:
        op(t)
    return t


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The group's elementwise sum of ``t`` (a new tensor, no gradient);
    ``t`` itself without a group."""
    if not active():
        return t
    out = t.detach().clone()
    return _through_card(out, dist.all_reduce)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """``(W, *t.shape)``: every rank's ``t`` in rank order (no gradient),
    as a sum of buffers in which each rank fills its own slot;
    ``t[None]`` without a group."""
    if not active():
        return t.detach()[None]
    buf = t.new_zeros((world_size(), *t.shape))
    buf[rank()] = t.detach()
    return _through_card(buf, dist.all_reduce)


def gather_rows(local: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (any shape, global indices) of the concatenation of
    every rank's ``local`` (n, ...) in rank order, the global batch's
    image order.  The rows this rank owns keep their gradient; the
    others come from their ranks, detached.  Only the rows asked for
    cross the group.  Without a group: ``local[idx]``."""
    if not active():
        return local[idx]
    n = local.shape[0]
    lo = rank() * n
    mine = (idx >= lo) & (idx < lo + n)
    picked = local[(idx - lo).clamp(0, n - 1)]
    mine = mine.reshape(*mine.shape, *([1] * (local.dim() - 1)))
    picked = torch.where(mine, picked, torch.zeros_like(picked))
    return torch.where(mine, picked, all_sum(picked))


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor in place with rank ``src``'s, one broadcast
    per (device, dtype) of flattened tensors."""
    if not active():
        return
    groups: Dict[tuple, list] = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        _through_card(flat, lambda x: dist.broadcast(x, src))
        off = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


def all_reduce_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum the gradients of ``params`` over the group in place, one
    all-reduce per dtype of one flat buffer.  Every rank holds the same
    parameters, so the same ones have gradients."""
    if not active():
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        _through_card(flat, dist.all_reduce)
        parts = torch.split(flat, [g.numel() for g in gs])
        torch._foreach_copy_(gs, [v.view_as(g) for g, v in zip(gs, parts)])


def reduce_metrics(metrics: Dict[str, torch.Tensor],
                   replicated: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """The group's metrics from each rank's: the ranks' shares summed in
    one all-reduce, the ``replicated`` ones (already the group's, equal
    on every rank) as they are."""
    if not active():
        return metrics
    keys = [k for k in metrics if k not in replicated]
    summed = all_sum(torch.stack([metrics[k].float() for k in keys]))
    out = dict(metrics)
    out.update({k: summed[i] for i, k in enumerate(keys)})
    return out


def barrier() -> None:
    if active():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def replicate(state):
    """Broadcast ``state`` from rank 0 in place and return it: an
    ``nn.Module`` (parameters and buffers) or a train state (its model,
    optimizer tensors, EMA, BoIW dictionary, generator state, step and
    update count)."""
    if not active():
        return state
    if isinstance(state, torch.nn.Module):
        broadcast_(state.state_dict().values())
    else:
        _replicate_train_state(state)
    return state


def _replicate_train_state(state) -> None:
    opt = state.optimizer
    tensors = list(state.model.state_dict().values())
    tensors += [state.ema_params[k] for k in sorted(state.ema_params)]
    for p in (p for g in opt.param_groups for p in g["params"]):
        tensors += [v for _, v in sorted(opt.state.get(p, {}).items())
                    if torch.is_tensor(v)]
    if state.boiw is not None:
        tensors += list(state.boiw)
    broadcast_(tensors)
    gen = state.generator.get_state()
    broadcast_([gen])
    state.generator.set_state(gen)
    host = torch.tensor([int(state.step), int(getattr(opt, "count", 0))],
                        dtype=torch.int64)
    broadcast_([host])
    state.step = int(host[0])
    if hasattr(opt, "count"):
        opt.count = int(host[1])


def multiscale_size(step: int, sizes, interval: int = 10,
                    seed: int = 42):
    """Deterministic multi-scale schedule (``glsdet_tpu.parallel.mesh``'s
    ``multiscale_size``): a step-seeded splitmix hash picks the size of
    each ``interval``-step bucket, the same on every process with no
    communication (the reference broadcasts a random size from rank 0,
    SyncRandomSizeHook)."""
    bucket = step // interval
    h = (bucket * 0x9E3779B97F4A7C15 + seed) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 30
    h = (h * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 27
    return sizes[h % len(sizes)]
