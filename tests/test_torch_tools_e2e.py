"""``glsdet_tpu_torch.tools.visdrone_e2e`` on the CPU: the five stages of
``scripts/visdrone_e2e.sh`` (convert, train the coarse detector, build
the UFP dataset, train MP-Det, the two-stage eval) at a tiny preset
(``--synthetic`` with its writer cut to 8 train and 2 val frames,
YOLOX-nano at 64x64,
MP-Det-18 at 128x128, one epoch each, set through the script's
``GLSDET_E2E_*_OPTS``).  The synthetic layout is byte-equal to the one
the script's own writer (OpenCV) makes, and a build that writes no
mosaic fails the run, as the script does."""

import json
import os
import re
import sys

import pytest

from glsdet_tpu_torch.tools import visdrone_e2e as tool
from torch_tools_util import ROOT

TINY = {
    "GLSDET_E2E_COARSE_OPTS": (
        "data.img_hw=(64,64) train.epochs=1 train.ckpt_interval=1 "
        "train.warmup_epochs=0 train.num_last_epochs=0 data.num_workers=0 "
        "eval.coarse_score_thr=0.0001"),
    "GLSDET_E2E_MP_OPTS": ("data.img_hw=(128,128) train.epochs=1 "
                           "train.ckpt_interval=1 data.num_workers=0"),
    "GLSDET_E2E_EVAL_OPTS": ("data.img_hw=(64,64) eval.coarse_score_thr=0.0001 "
                             "eval.mosaic_buckets=(128,256)"),
}


def test_synthetic_layout_is_the_scripts(tmp_path, monkeypatch):
    with open(os.path.join(ROOT, "scripts", "visdrone_e2e.sh")) as f:
        script = f.read()
    writer = re.search(r"python - \"\$TRAIN_ROOT\" \"\$VAL_ROOT\" "
                       r"<<'PYEOF'\n(.*?)PYEOF", script, re.S).group(1)
    want = [str(tmp_path / "cv2" / k) for k in ("train", "val")]
    monkeypatch.setattr(sys, "argv", ["-", *want])
    exec(compile(writer, "visdrone_e2e.sh", "exec"), {})
    for root, n, seed in zip(want, (48, 8), (0, 1)):
        got = root.replace("cv2", "port")
        tool.write_synthetic(got, n, seed)
        for sub in ("images", "annotations"):
            names = sorted(os.listdir(os.path.join(root, sub)))
            assert names == sorted(os.listdir(os.path.join(got, sub)))
            assert len(names) == n
            for name in names:
                with open(os.path.join(root, sub, name), "rb") as a, \
                        open(os.path.join(got, sub, name), "rb") as b:
                    assert a.read() == b.read(), (sub, name)


def fewer_frames(monkeypatch, n_train, n_val):
    """``--synthetic`` writes ``n_train`` / ``n_val`` frames (the first
    of the script's 48 / 8)."""
    real = tool.write_synthetic
    monkeypatch.setattr(tool, "write_synthetic", lambda root, n, seed: real(
        root, min(n, n_train if seed == 0 else n_val), seed))


def test_synthetic_cycle_runs_end_to_end(tmp_path, monkeypatch, capsys):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    fewer_frames(monkeypatch, 8, 2)
    wd = str(tmp_path / "wd")
    out = tool.main(["--synthetic", wd, "--device", "cpu"])
    assert out["convert"]["result"] == [8, 2]
    assert out["train_coarse"]["result"].step == 2        # 8 frames at 4
    ufp = out["build_ufp"]["result"]
    assert ufp["frames"] == 8 and ufp["mosaics"] > 0
    with open(os.path.join(wd, "ufp", "ufp_train.json")) as f:
        assert len(json.load(f)["images"]) == ufp["mosaics"]
    assert out["train_mp"]["result"].step >= 1
    assert out["coarse_ckpt"] == f"{wd}/coarse/epoch_1.pt"
    assert os.path.exists(out["mp_ckpt"])
    res, stats = out["eval"]["result"]
    assert stats["images"] == 2 and -1.0 <= out["ap"] <= 1.0
    with open(os.path.join(wd, "eval.log")) as f:
        assert "AP@[.5:.95]" in f.read()
    assert os.path.exists(os.path.join(wd, "val_dets.json"))
    assert "VISDRONE E2E COMPLETE" in capsys.readouterr().out


def test_no_mosaic_fails_the_run(tmp_path, monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("GLSDET_E2E_COARSE_OPTS", TINY[
        "GLSDET_E2E_COARSE_OPTS"].replace("eval.coarse_score_thr=0.0001",
                                          "eval.coarse_score_thr=1.5"))
    fewer_frames(monkeypatch, 4, 1)
    with pytest.raises(AssertionError, match="0 mosaics"):
        tool.main(["--synthetic", str(tmp_path / "wd"), "--device", "cpu"])
