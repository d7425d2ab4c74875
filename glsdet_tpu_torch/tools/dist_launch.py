"""Multi-process launcher, the counterpart of the JAX package's
``scripts/dist_train.sh`` and ``scripts/dist_test.sh``:

    python -m glsdet_tpu_torch.tools.dist_launch train coarse_det 2 \\
        --ann data/train.json --img-root data/images
    python -m glsdet_tpu_torch.tools.dist_launch test coarse_det 2 \\
        --ckpt work_dirs/coarse_det/epoch_12.pt --ann data/val.json \\
        --img-root data/images --device cpu

starts NPROC local processes of ``python -m glsdet_tpu_torch.tools.
{train,test} CONFIG [args]`` with ``GLSDET_COORDINATOR``,
``GLSDET_NUM_PROCESSES`` and ``GLSDET_PROCESS_ID`` set, which the
commands read (``parallel/mesh.py: maybe_init_distributed``): one rank
per card over NCCL with ``--device cuda`` (the default), gloo with
``--device cpu``.  ``--backend gloo`` lets ranks share a card.  When a
process fails the others are stopped; the exit code is the first
failure's, else 0.  Under SLURM no launcher is needed: ``srun`` sets
``SLURM_NTASKS`` / ``SLURM_PROCID`` and the job sets
``GLSDET_COORDINATOR`` to rank 0's host.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, default=None,
                    help="rank 0's port on this host (default: a free one)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the collectives' backend (default: NCCL on "
                         "cards, gloo on the CPU); gloo lets ranks share "
                         "one card")
    ap.add_argument("command", choices=("train", "test"))
    ap.add_argument("config")
    ap.add_argument("nproc", type=int)
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="the command's own arguments")
    return ap


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(procs: List[subprocess.Popen]) -> int:
    """The first non-zero exit code (the other processes then stopped),
    else 0 once every process has ended."""
    while True:
        codes = [p.poll() for p in procs]
        failed = [c for c in codes if c not in (None, 0)]
        if failed:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            return failed[0]
        if all(c == 0 for c in codes):
            return 0
        time.sleep(0.2)


def main(argv: Optional[List[str]] = None) -> int:
    """Launch and wait; returns the exit code."""
    args = parser().parse_args(argv)
    if args.nproc < 1:
        raise ValueError(f"nproc {args.nproc}: expected at least 1")
    env = dict(os.environ,
               GLSDET_COORDINATOR=f"127.0.0.1:{args.port or free_port()}",
               GLSDET_NUM_PROCESSES=str(args.nproc))
    if args.backend:
        env["GLSDET_DIST_BACKEND"] = args.backend
    cmd = [sys.executable, "-m", f"glsdet_tpu_torch.tools.{args.command}",
           args.config, *args.args]
    procs = []
    try:
        for rank in range(args.nproc):
            procs.append(subprocess.Popen(
                cmd, env=dict(env, GLSDET_PROCESS_ID=str(rank))))
        return _wait(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


if __name__ == "__main__":
    sys.exit(main())
