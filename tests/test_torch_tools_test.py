"""``glsdet_tpu_torch.tools.test`` against the JAX package's
``tools/test.py``, both run here on the CPU (``--device cpu``, float32)
on one JAX ``TrainState`` (orbax) of a seeded YOLOX-nano at 64x64 whose
BatchNorm statistics are calibrated on the eval's own letterboxed
frames and whose EMA differs from its weights in the score convolutions
(``torch_tools_util.jax_checkpoint``), over 8 PNG frames whose ground
truth is the port's own detections, jittered and thinned (so that AP is
well above 0 and a wrong weight choice moves it).  The calibration
spreads the scores: at the seeded statistics every frame's best anchors
score the same to float32 precision, and AP's ranking then breaks those
ties either way.

- plain, ``--use-ema`` and ``--fuse-conv-bn``: the ``--out`` detections
  match one to one (same label, IoU > 0.99, scores within 1e-4), and the
  COCO stats each tool computed agree within 1e-3, as do those of each
  tool's ``--out`` file scored by its own package's ``eval_metric``
  CLI.
- TTA (scales 1.0 and 1.25, flip): at least 99% of the detections match
  both ways and the stats agree within 1e-2.  The JAX ``tta_detect``
  ranks the union of the variants with numpy's unstable sort and the
  port's is stable (ROADMAP.md §C), so near-tied variants of an anchor
  may be cut at ``max_dets`` either way.
- ``--int8`` and ``--int8-static`` with the scales file the JAX CLI
  wrote (``--int8-scales``): the port's own calibration gives that
  file's keys and values within 1e-4 relative, and the stats agree
  within 0.05.  The int8 chain amplifies last-bit differences: one code
  of an activation that XLA and PyTorch round on either side of .5 moves
  every later layer's codes (ROADMAP.md §C), so detections near the
  score threshold come and go.
- ``--format-only`` writes ``--out`` and returns no result,
  ``--show-dir`` one PNG a frame; ``--dist-*`` or SLURM's environment
  make the process one rank of a group, which evaluates as a process
  alone (``tools/dist_launch.py`` across two processes:
  ``test_torch_dist_loop.py``); the default device is the card.
"""
import json
import os

import numpy as np
import pytest
import torch

import glsdet_tpu.eval.coco_eval  # noqa: F401  (patched by name)
import glsdet_tpu.eval.runner as jrunner
from glsdet_tpu_torch.data.image_io import read_image
from glsdet_tpu_torch.parallel import mesh
from glsdet_tpu_torch.tools import dist_launch
from glsdet_tpu_torch.tools import test as tool
from test_torch_eval_runner import Recorder, _match
from glsdet_tpu.data.augment import letterbox
from torch_tools_util import (CAT_IDS, COARSE_CLI, frame, gts_from_dump,
                              jax_checkpoint, run_jax,
                              traced_init_patch, write_set)

FRAMES = [(96, 160), (80, 120), (64, 64), (100, 75), (90, 150),
          (120, 120), (72, 128), (110, 90)]
OPTS = ["--cfg-options", *COARSE_CLI, "eval.score_thr=0.001"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tools_test"))
    calibration = np.stack([letterbox(frame(i, hw), np.zeros((0, 4)),
                                      (64, 64))[0]
                            for i, hw in enumerate(FRAMES)])
    ckpt = jax_checkpoint(os.path.join(root, "ckpt"), "coarse_det",
                          COARSE_CLI, seed=11, calibration=calibration)
    ann, img_root = write_set(root, FRAMES, name="bare.json")
    dump = os.path.join(root, "bare_dets.json")
    tool.main(["coarse_det", "--ckpt", ckpt, "--ann", ann, "--img-root",
               img_root, "--out", dump, "--format-only", *OPTS,
               "--device", "cpu"])
    ann, img_root = write_set(root, FRAMES, gts=gts_from_dump(dump, 0))
    return root, ckpt, ann, img_root


def _by_img(path):
    with open(path) as f:
        dump = json.load(f)
    out = {100 + i: ([], [], []) for i in range(len(FRAMES))}
    for d in dump:
        b, s, lab = out[d["image_id"]]
        b.append(d["bbox"])
        s.append(d["score"])
        lab.append(CAT_IDS.index(d["category_id"]))
    return {k: (np.asarray(b, np.float32).reshape(-1, 4),
                np.asarray(s, np.float32), np.asarray(lab))
            for k, (b, s, lab) in out.items()}


def _run_both(setup, tmp_path, extra):
    """Both CLIs on the set with ``extra`` flags; returns (port result,
    JAX result, port dump, JAX dump)."""
    root, ckpt, ann, img_root = setup
    base = ["coarse_det", "--ckpt", ckpt, "--ann", ann, "--img-root",
            img_root, *OPTS]
    jout, tout = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    rec = Recorder(jrunner.CocoEvaluator)
    run_jax("test", [*base, *extra, "--out", jout],
            **{"glsdet_tpu.eval.runner:CocoEvaluator": rec,
               **traced_init_patch()})
    got, _ = tool.main([*base, *extra, "--out", tout, "--device", "cpu"])
    assert len(rec.calls) == 1
    return got, rec.calls[0][2], _by_img(tout), _by_img(jout)


MODES = {"plain": [], "ema": ["--use-ema"], "fuse": ["--fuse-conv-bn"],
         "tta": ["--tta-scales", "1.0", "1.25", "--tta-flip"]}
AR = slice(6, 12)


def _dump_stats(setup, tmp_path):
    """Each tool's ``--out`` scored by its own package's ``eval_metric``
    CLI: (port stats, JAX stats)."""
    from glsdet_tpu_torch.tools import eval_metric

    ann = setup[2]
    got = eval_metric.main([str(tmp_path / "port.json"), "--ann", ann])
    rec = Recorder(jrunner.CocoEvaluator)
    run_jax("eval_metric", [str(tmp_path / "jax.json"), "--ann", ann],
            **{"glsdet_tpu.eval.coco_eval:CocoEvaluator": rec})
    assert len(rec.calls) == 1
    return got.stats, rec.calls[0][2].stats


@pytest.mark.parametrize("mode", sorted(MODES))
def test_port_cli_matches_jax_cli(setup, tmp_path, mode):
    got, want, gdets, wdets = _run_both(setup, tmp_path, MODES[mode])
    pairs, n_got, n_want = _match(gdets, wdets, score_tol=1e-4)
    assert want.ap > 0.1 and n_want > 500, (want.ap, n_want)
    got_dump, want_dump = _dump_stats(setup, tmp_path)
    if mode == "tta":
        assert pairs >= 0.99 * n_want and pairs >= 0.99 * n_got, (
            pairs, n_got, n_want)
        np.testing.assert_allclose(got.stats, want.stats, atol=1e-2)
        np.testing.assert_allclose(got_dump, want_dump, atol=1e-2)
        return
    assert pairs == n_got == n_want, (pairs, n_got, n_want)
    np.testing.assert_allclose(got_dump, want_dump, atol=1e-3)
    np.testing.assert_allclose(got.stats, want.stats, atol=1e-3)


def test_use_ema_and_fuse_change_what_is_evaluated(setup, tmp_path):
    """The EMA is not the weights (the JAX CLI evaluates ``params``
    without ``--use-ema``), and folding BN changes no detection."""
    root, ckpt, ann, img_root = setup
    base = ["coarse_det", "--ckpt", ckpt, "--ann", ann, "--img-root",
            img_root, *OPTS, "--device", "cpu"]
    runs = {}
    for mode in ("plain", "ema", "fuse"):
        out = str(tmp_path / f"{mode}.json")
        runs[mode] = (tool.main([*base, *MODES[mode], "--out", out])[0],
                      _by_img(out))
    assert not np.array_equal(runs["plain"][0].stats, runs["ema"][0].stats)
    pairs, n_got, n_want = _match(runs["fuse"][1], runs["plain"][1],
                                  score_tol=1e-4)
    assert pairs == n_got == n_want > 500
    np.testing.assert_allclose(runs["fuse"][0].stats[AR],
                               runs["plain"][0].stats[AR], atol=1e-3)


INT8_TOL = 0.05


def test_int8_static_reads_the_jax_scales(setup, tmp_path):
    scales = str(tmp_path / "scales.json")
    got, want, gdets, wdets = _run_both(setup, tmp_path,
                                        ["--int8-scales", scales])
    np.testing.assert_allclose(got.stats, want.stats, atol=INT8_TOL)
    assert want.ap > 0.05
    # the port's own calibration (the first 2 eval batches) gives the
    # JAX CLI's scales
    root, ckpt, ann, img_root = setup
    own = str(tmp_path / "own.json")
    tool.main(["coarse_det", "--ckpt", ckpt, "--ann", ann, "--img-root",
               img_root, *OPTS, "--int8-static", "--int8-scales", own,
               "--format-only", "--out", str(tmp_path / "o.json"),
               "--device", "cpu"])
    with open(scales) as f:
        jax_scales = json.load(f)["scales"]
    with open(own) as f:
        port_scales = json.load(f)["scales"]
    assert port_scales.keys() == jax_scales.keys() and len(jax_scales) > 20
    for k, v in jax_scales.items():
        assert abs(port_scales[k] - v) <= 1e-4 * abs(v), (k, v)


def test_int8_dynamic_matches_jax(setup, tmp_path):
    got, want, _, _ = _run_both(setup, tmp_path, ["--int8"])
    np.testing.assert_allclose(got.stats, want.stats, atol=INT8_TOL)
    assert want.ap > 0.05


def test_outputs_and_guards(setup, tmp_path, monkeypatch):
    root, ckpt, ann, img_root = setup
    base = ["coarse_det", "--ckpt", ckpt, "--ann", ann, "--img-root",
            img_root, *OPTS]
    out, show = str(tmp_path / "d.json"), str(tmp_path / "show")
    res, stats = tool.main([*base, "--out", out, "--format-only",
                            "--show-dir", show, "--device", "cpu"])
    assert res is None and stats["images"] == len(FRAMES)
    with open(out) as f:
        assert {d["image_id"] for d in json.load(f)} == {
            100 + i for i in range(len(FRAMES))}
    for i, hw in enumerate(FRAMES):
        assert read_image(os.path.join(show, f"{i}.png")).shape == (*hw, 3)
    with pytest.raises(SystemExit):
        tool.main([*base, "--format-only", "--device", "cpu"])
    # one rank of a process group, joined from the flags and then from
    # SLURM's environment (gloo; a group of one here, two in
    # test_torch_dist_loop.py): the result of a process alone, and the
    # group left at the end
    joins = []
    real_init = mesh.init_distributed
    monkeypatch.setattr(mesh, "init_distributed", lambda *a, **kw: (
        joins.append(a), real_init(*a, **kw))[1])
    one = [*base, "--max-images", "1", "--device", "cpu"]
    alone, _ = tool.main(one)
    addr = f"127.0.0.1:{dist_launch.free_port()}"
    flags, _ = tool.main([*one, "--dist-coordinator", addr,
                          "--dist-num-processes", "1",
                          "--dist-process-id", "0"])
    monkeypatch.setenv("GLSDET_COORDINATOR",
                       f"127.0.0.1:{dist_launch.free_port()}")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    monkeypatch.setenv("SLURM_PROCID", "0")
    env, _ = tool.main(one)
    assert [a[1:] for a in joins] == [(1, 0), (1, 0)] and not mesh.active()
    np.testing.assert_array_equal(flags.stats, alone.stats)
    np.testing.assert_array_equal(env.stats, alone.stats)
    # a count of 1 without a coordinator runs alone
    monkeypatch.delenv("GLSDET_COORDINATOR")
    monkeypatch.setenv("GLSDET_NUM_PROCESSES", "1")
    tool.main(one)
    assert len(joins) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            tool.main(base)
