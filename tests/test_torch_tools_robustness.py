"""``glsdet_tpu_torch.tools.test_robustness`` against the JAX package's
``tools/test_robustness.py``, both run on the CPU (``--device
cpu``, float32) on one JAX ``TrainState`` (orbax) of a seeded YOLOX-nano
at 64x64 whose BatchNorm statistics are calibrated on the eval's own
letterboxed frames (``torch_tools_util.jax_checkpoint(calibration=)``,
as ``tests/test_torch_tools_test.py`` does: at seeded statistics AP's
ranking breaks float32 ties either way), over 6 PNG frames whose ground
truth is the port's own detections, jittered and thinned.

- The grid (a noise, both blurs, the JPEG round trip and ``pixelate`` at
  severity 5; ``motion_blur`` and ``pixelate`` at 3 with ``--use-ema``),
  the clean AP, mPC and rPC agree within 1e-3, ``run_eval``'s
  tolerance in the tools tests, and the printed lines carry the same
  corruptions and severities; ``--out`` writes the returned grid.
- ``--corruptions`` runs the subset it names, ``--use-ema`` changes what
  is evaluated as in the JAX CLI (its EMA differs from the weights in the
  score convolutions)."""

import json
import os

import numpy as np
import pytest

from glsdet_tpu.data.augment import letterbox
from glsdet_tpu_torch.tools import test as tool_test
from glsdet_tpu_torch.tools import test_robustness
from torch_tools_util import (COARSE_CLI, frame, gts_from_dump,
                              jax_checkpoint, run_jax, traced_init_patch,
                              write_set)

FRAMES = [(96, 160), (80, 120), (64, 64), (100, 75), (90, 150), (120, 120)]
OPTS = ["--cfg-options", *COARSE_CLI, "eval.score_thr=0.001"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("robustness"))
    calibration = np.stack([letterbox(frame(i, hw), np.zeros((0, 4)),
                                      (64, 64))[0]
                            for i, hw in enumerate(FRAMES)])
    ckpt = jax_checkpoint(os.path.join(root, "ckpt"), "coarse_det",
                          COARSE_CLI, seed=11, calibration=calibration)
    ann, img_root = write_set(root, FRAMES, name="bare.json")
    dump = os.path.join(root, "bare_dets.json")
    tool_test.main(["coarse_det", "--ckpt", ckpt, "--ann", ann, "--img-root",
                    img_root, "--out", dump, "--format-only", *OPTS,
                    "--device", "cpu"])
    ann, img_root = write_set(root, FRAMES, gts=gts_from_dump(dump, 0))
    return root, ckpt, ann, img_root


def _run_both(setup, capsys, extra):
    root, ckpt, ann, img_root = setup
    base = ["coarse_det", "--ckpt", ckpt, "--ann", ann, "--img-root",
            img_root, *extra, *OPTS]
    jout, pout = (os.path.join(root, f"{k}.json") for k in ("jax", "port"))
    capsys.readouterr()
    run_jax("test_robustness", [*base, "--out", jout], **traced_init_patch())
    want_lines = capsys.readouterr().out.splitlines()
    got = test_robustness.main([*base, "--out", pout, "--device", "cpu"])
    got_lines = capsys.readouterr().out.splitlines()
    with open(jout) as f:
        want = json.load(f)
    with open(pout) as f:
        assert json.load(f) == json.loads(json.dumps(got))
    return got, want, got_lines, want_lines


def _close(got, want):
    assert got["severities"] == want["severities"]
    assert list(got["grid"]) == list(want["grid"])
    for name in want["grid"]:
        np.testing.assert_allclose(got["grid"][name], want["grid"][name],
                                   atol=1e-3, err_msg=name)
    for key in ("clean_ap", "mPC", "rPC"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-3,
                                   err_msg=key)


def _labels(lines):
    """Each printed line without its numbers."""
    return [line.split("=")[0] for line in lines if "wrote" not in line]


def test_grid_matches_jax(setup, capsys):
    got, want, gl, wl = _run_both(setup, capsys, [
        "--corruptions", "shot_noise", "defocus_blur", "motion_blur",
        "jpeg_compression", "pixelate", "--severities", "5"])
    assert want["clean_ap"] > 0.1, want["clean_ap"]
    assert len(want["grid"]) == 5
    _close(got, want)
    assert _labels(gl) == _labels(wl)
    # the corruptions move AP: the grid is not the clean AP five times
    cells = np.array(list(got["grid"].values()))
    assert np.abs(cells - got["clean_ap"]).max() > 0.05


def test_subset_and_ema_match_jax(setup, capsys):
    extra = ["--corruptions", "motion_blur", "pixelate", "--severities",
             "3", "--use-ema", "--max-images", "4"]
    got, want, gl, wl = _run_both(setup, capsys, extra)
    assert list(got["grid"]) == ["motion_blur", "pixelate"]
    _close(got, want)
    assert _labels(gl) == _labels(wl)
    root, ckpt, ann, img_root = setup
    plain = test_robustness.main(
        ["coarse_det", "--ckpt", ckpt, "--ann", ann, "--img-root", img_root,
         *[a for a in extra if a != "--use-ema"], *OPTS, "--device", "cpu"])
    assert plain["clean_ap"] != got["clean_ap"]
