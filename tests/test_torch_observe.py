"""``glsdet_tpu_torch/utils/observe.py`` against the JAX package's
``utils/observe.py``: the logger's handlers and format, profile_time's
line and profiler span, collect_env's keys and LossHistory's files."""

import os

import pytest
import torch

from glsdet_tpu.utils import observe as jobs
from glsdet_tpu_torch.utils import observe


def test_root_logger_handlers_and_format(tmp_path):
    log = str(tmp_path / "run.log")
    logger = observe.get_root_logger(log)
    try:
        assert logger.name == "glsdet_tpu_torch"
        kinds = sorted(type(h).__name__ for h in logger.handlers)
        assert kinds == ["FileHandler", "StreamHandler"]
        fmts = {h.formatter._fmt for h in logger.handlers}
        assert fmts == {"%(asctime)s - %(levelname)s - %(message)s"}
        assert observe.get_root_logger() is logger
        logger.info("hello %d", 3)
        for h in logger.handlers:
            h.flush()
        assert open(log).read().rstrip().endswith(" - INFO - hello 3")
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()


def test_profile_time_line_and_span(capsys):
    with torch.profiler.profile() as prof:
        with observe.profile_time("trace", "block"):
            torch.ones(8).sum()
    line = capsys.readouterr().out.strip()
    assert line.startswith("trace block cpu_time ") and line.endswith(" ms")
    float(line.split()[3])
    assert "trace:block" in {e.key for e in prof.key_averages()}
    with observe.profile_time("trace", "off", enabled=False):
        pass
    assert capsys.readouterr().out == ""


def test_collect_env_keys():
    env = observe.collect_env()
    jenv = jobs.collect_env()
    # torch, CUDA, cuDNN and the device names where JAX has jax, its
    # devices and backend; python and the git hash as in the JAX package
    assert set(env) - {"git_hash"} == {"python", "torch", "cuda", "cudnn",
                                       "devices"}
    assert env["python"] == jenv["python"]
    assert env["torch"] == torch.__version__
    assert env["devices"] == ["cpu"]
    assert env.get("git_hash") == jenv.get("git_hash")


@pytest.mark.parametrize("with_val", [False, True])
def test_loss_history_files_equal_jax(tmp_path, with_val):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    a, b = observe.LossHistory(ours), jobs.LossHistory(theirs)
    for i, loss in enumerate([3.5, 2.25, 1.125, 0.9, 0.8, 0.75]):
        val = loss + 0.5 if with_val else None
        a.append_loss(loss, val)
        b.append_loss(loss, val)
    for name in ("epoch_loss.txt", "epoch_val_loss.txt"):
        p, j = os.path.join(ours, name), os.path.join(theirs, name)
        assert os.path.exists(p) == os.path.exists(j)
        if os.path.exists(j):
            assert open(p).read() == open(j).read()
    # the port draws the plot without matplotlib, which the GPU machine
    # lacks: a PNG whatever is installed
    from glsdet_tpu_torch.data.image_io import read_image

    plot = read_image(os.path.join(ours, "epoch_loss.png"))
    assert plot.shape == (480, 640, 3)
    assert ((plot == (255, 0, 0)).all(-1)).sum() > 100
    assert ((plot == (255, 127, 80)).all(-1)).any() == with_val
