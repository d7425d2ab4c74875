"""Tracing / profiling / logging / env collection, the counterpart of the
JAX package's ``utils/observe.py``.

Behavioral references:
- ``mmdet/utils/profiling.py:11`` (profile_time: per-block device+cpu ms
  context manager; the JAX package fences with ``block_until_ready``,
  the port with ``torch.cuda.synchronize`` where the card is in use).
- ``yolox-drone/models/core/callbacks.py:10`` (LossHistory: per-epoch
  loss txt + smoothed plot in the work dir, drawn in numpy).
- ``mmdet/utils/collect_env.py`` + logger (env + git hash).
"""

from __future__ import annotations

import contextlib
import logging
import os
import subprocess
import sys
import time
from typing import List, Optional

import torch


def get_root_logger(log_file: Optional[str] = None,
                    level=logging.INFO) -> logging.Logger:
    """The port's logger (``train/loop.py`` logs to it): a stream
    handler and, given ``log_file``, a file handler, both in the JAX
    package's format; set up once."""
    logger = logging.getLogger("glsdet_tpu_torch")
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def _card_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def profile_time(trace_name: str, name: str, enabled: bool = True,
                 stream=None, end_stream=None):
    """Per-block timing (profiling.py:11 API shape): the block runs in a
    ``torch.profiler.record_function`` span named ``trace_name:name``,
    and its host time, fenced by ``torch.cuda.synchronize`` before and
    after where the card is in use (so it covers the block's kernels), is
    printed as ``<trace_name> <name> cpu_time <ms> ms``.  ``stream`` and
    ``end_stream`` are accepted for the API's sake, as in the JAX
    package."""
    if not enabled:
        yield
        return
    fence = _card_in_use()
    with torch.profiler.record_function(f"{trace_name}:{name}"):
        if fence:
            torch.cuda.synchronize()
        t0 = time.monotonic()
        try:
            yield
        finally:
            if fence:
                torch.cuda.synchronize()
            dt = time.monotonic() - t0
            print(f"{trace_name} {name} cpu_time {dt * 1000:.2f} ms")


def collect_env() -> dict:
    """Environment snapshot: python, torch, CUDA and cuDNN versions, the
    devices and the git hash of the checkout (where it is one)."""
    cuda = torch.cuda.is_available()
    info = {
        "python": sys.version.replace("\n", " "),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cudnn": torch.backends.cudnn.version() if cuda else None,
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
    }
    try:
        git = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
        if git.returncode == 0:
            info["git_hash"] = git.stdout.strip()
    except OSError:
        pass
    return info


class LossHistory:
    """Per-epoch loss log + smoothed plot (callbacks.py:10).

    Writes ``epoch_loss.txt`` / ``epoch_val_loss.txt`` and
    ``epoch_loss.png`` per append (drawn in numpy, where the JAX package
    plots with matplotlib).
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.losses: List[float] = []
        self.val_losses: List[float] = []

    def append_loss(self, loss: float, val_loss: Optional[float] = None):
        self.losses.append(float(loss))
        with open(os.path.join(self.log_dir, "epoch_loss.txt"), "a") as f:
            f.write(f"{float(loss)}\n")
        if val_loss is not None:
            self.val_losses.append(float(val_loss))
            with open(os.path.join(self.log_dir,
                                   "epoch_val_loss.txt"), "a") as f:
                f.write(f"{float(val_loss)}\n")
        self._plot()

    def _plot(self):
        """``epoch_loss.png``: the train loss (red), the val loss (coral)
        and, from 5 epochs on, the train loss smoothed by a Savitzky-Golay
        filter (green; scipy's, where it imports), drawn by
        ``utils/plot.py: line_plot`` (the GPU machine has no
        matplotlib)."""
        from glsdet_tpu_torch.data.image_io import write_png
        from glsdet_tpu_torch.utils.plot import line_plot

        curves = [(self.losses, (255, 0, 0))]
        if self.val_losses:
            curves.append((self.val_losses, (255, 127, 80)))
        if len(self.losses) >= 5:
            try:
                from scipy.signal import savgol_filter

                num = 5 if len(self.losses) < 25 else 15
                curves.append((list(savgol_filter(self.losses, num, 3)),
                               (0, 128, 0)))
            except ImportError:
                pass
        n = max(len(self.losses), len(self.val_losses), 2) - 1
        img = line_plot([(range(len(ys)), ys, color) for ys, color in curves],
                        x_range=(0, n))
        write_png(os.path.join(self.log_dir, "epoch_loss.png"), img)
