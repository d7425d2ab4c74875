"""``glsdet_tpu_torch/tools/ckpt_tool.py`` on the port's own training
checkpoints (``train/state.py: state_dict``): every command's round trip,
its message in the JAX tool's format, and the stripped and published
files served by ``apis.init_detector``."""

import os
import re

import pytest
import torch

from glsdet_tpu_torch import apis
from glsdet_tpu_torch.config import apply_overrides, get_config
from glsdet_tpu_torch.models.build import build_model
from glsdet_tpu_torch.tools import ckpt_tool
from glsdet_tpu_torch.train.loop import build_optimizer, make_state_template
from glsdet_tpu_torch.train.state import state_dict

OPTS = {"coarse_det": {"model.phi": "nano"},
        "mp_det_res50": {"model.depth": 18}}


@pytest.fixture(scope="module", params=sorted(OPTS))
def ckpt(request, tmp_path_factory):
    """A checkpoint whose EMA differs from its parameters, at step 7."""
    name = request.param
    tmp_path = tmp_path_factory.mktemp(name)
    cfg = apply_overrides(get_config(name), OPTS[name])
    model = build_model(cfg, device="cpu")
    state = make_state_template(cfg, model, build_optimizer(cfg, 10, model),
                                torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for v in state.ema_params.values():
        v.add_(torch.randn(v.shape, generator=g))
    state.step = 7
    path = str(tmp_path / "epoch_3.pt")
    torch.save(state_dict(state), path)
    return name, path, torch.load(path, weights_only=True)


def test_inspect(ckpt, capsys):
    name, path, raw = ckpt
    ckpt_tool.main(["inspect", path])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "step: 7"
    sections = sorted(k for k in raw if k != "step")
    assert [line.split()[0] for line in out[1:]] == sections
    n = sum(1 for _ in raw["model"].values())
    assert re.match(rf"model\s+{n} arrays\s+[\d.]+M params\s+[\d.]+ MB",
                    next(line for line in out if line.startswith("model")))
    ckpt_tool.main(["inspect", "-v", path])
    verbose = capsys.readouterr().out
    key = next(iter(raw["model"]))
    assert f"  model/{key} {tuple(raw['model'][key].shape)}" in verbose


def test_restamp(ckpt, tmp_path, capsys):
    name, path, raw = ckpt
    dst = str(tmp_path / "re.pt")
    ckpt_tool.main(["restamp", path, dst, "--step", "0"])
    assert capsys.readouterr().out.strip() == f"{path} -> {dst} (step=0)"
    got = torch.load(dst, weights_only=True)
    assert got["step"] == 0
    for k in raw["model"]:
        assert torch.equal(got["model"][k], raw["model"][k])


@pytest.mark.parametrize("keep_ema", [True, False])
def test_strip_serves_through_init_detector(ckpt, tmp_path, capsys,
                                            keep_ema):
    name, path, raw = ckpt
    dst = str(tmp_path / "s.pt")
    ckpt_tool.main(["strip", path, dst] + ([] if keep_ema
                                           else ["--no-keep-ema"]))
    want = sorted(k for k in ("model", "boiw", "ema_params")
                  if raw.get(k) is not None
                  and (keep_ema or k != "ema_params"))
    assert capsys.readouterr().out.startswith(f"{path} -> {dst}: {want} (")
    got = torch.load(dst, weights_only=True)
    assert sorted(got) == want
    _, _, served = apis.init_detector(name, dst, options=OPTS[name],
                                      device="cpu")
    params = raw["ema_params"] if keep_ema else {}
    for k, v in raw["model"].items():
        assert torch.equal(served[k], params.get(k, v)), k


def test_swap_ema(ckpt, tmp_path, capsys):
    name, path, raw = ckpt
    dst = str(tmp_path / "w.pt")
    ckpt_tool.main(["swap-ema", path, dst])
    assert "(params <-> ema_params)" in capsys.readouterr().out
    got = torch.load(dst, weights_only=True)
    for k, v in raw["model"].items():
        want = raw["ema_params"].get(k, v)
        assert torch.equal(got["model"][k], want), k
    for k, v in raw["ema_params"].items():
        assert torch.equal(got["ema_params"][k], raw["model"][k]), k
    # serving the swapped file with use_ema gives the raw parameters
    _, _, served = apis.init_detector(name, dst, options=OPTS[name],
                                      device="cpu")
    for k, v in raw["model"].items():
        assert torch.equal(served[k], v), k
    stripped = str(tmp_path / "n.pt")
    torch.save({"model": raw["model"]}, stripped)
    with pytest.raises(SystemExit, match="no ema_params"):
        ckpt_tool.main(["swap-ema", stripped, dst])


def test_publish_names_the_file_by_its_content(ckpt, tmp_path, capsys):
    name, path, raw = ckpt
    first = ckpt_tool.main(["publish", path, str(tmp_path / "pub.pt")])
    again = ckpt_tool.main(["publish", path, str(tmp_path / "pub.pt")])
    assert first == again and os.path.exists(first)
    assert re.fullmatch(r".*/pub-[0-9a-f]{8}\.pt", first)
    assert f"-> {first}:" in capsys.readouterr().out
    assert first.endswith(
        ckpt_tool.content_hash(torch.load(first, weights_only=True))[:8]
        + ".pt")
    other = ckpt_tool.main(["publish", path, str(tmp_path / "pub.pt"),
                            "--no-keep-ema"])
    assert other != first
    _, _, served = apis.init_detector(name, first, options=OPTS[name],
                                      device="cpu")
    for k, v in raw["ema_params"].items():
        assert torch.equal(served[k], v), k
