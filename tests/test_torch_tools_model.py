"""The port's model commands (``benchmark``, ``get_flops``, ``summary``,
``export``, ``draw_cam``) against the JAX package's CLIs, on the CPU
at the tools tests' sizes (YOLOX-nano at 64x64 and MP-Det depth 18
at 128x128, float32, ``torch_tools_util.COARSE_CLI`` / ``MP_CLI``; the
commands without ``--cfg-options`` get these configs by patching each
package's ``get_config``), and the argument walk over every JAX CLI.

- ``get_flops``: the ``config`` and ``params`` lines equal the JAX
  CLI's, and the parameter counts at the full widths of ``coarse_det``
  and ``mp_det_res50`` equal the JAX models' ``params``.  The FLOPs
  equal an independent sum of 2 x MACs over the model's ``Conv2d`` and
  ``Linear`` modules (and MP-Det's proxy products).  The JAX CLI prints
  XLA's ``cost_analysis()["flops"]``, which counts elementwise work too
  and counts convolutions its own way: the test prints the ratio and
  holds it in (0.5, 2) (MP-Det-18 at 128x128: 1.13).
- ``summary``: the two total lines equal the JAX CLI's.
- ``benchmark``: the inference and ``--train`` lines in the JAX CLI's
  format, the trace file written.
- ``export``: the reloaded ``.pt2`` program's outputs equal the eager
  ones (``torch.equal``), with and without NMS, the NMS recorded as the
  ``glsdet_tpu_torch::nms_sorted`` operator; its ``round-trip ok`` line
  is the JAX CLI's for the same config; ``--ckpt`` takes the EMA.
- ``draw_cam``: the picked layer's name and shape (the ``layer:`` line)
  equal the JAX CLI's for the default ``--layer`` and for ``--layer neck
  --index 2``, the map before the upsampling within 1e-4, and the
  written overlay within 3 codes in at most 2% of its values (the float
  upsampling is within a few ulps of OpenCV's, and ``np.uint8(255 *
  cam)`` truncates).
- Every command asked for the card without one raises.
"""

import argparse
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

import glsdet_tpu.config as jconf
import glsdet_tpu.train.loop as jloop
import glsdet_tpu_torch.config as pconf
from glsdet_tpu_torch.data.image_io import read_image, write_png
from glsdet_tpu_torch.models.build import build_model
from glsdet_tpu_torch.tools import (benchmark, draw_cam, export, get_flops,
                                    summary, test_robustness)
from glsdet_tpu_torch.tools.common import ModelForward
from torch_tools_util import (COARSE_CLI, MP_CLI, ROOT, frame, jax_checkpoint,
                              jax_cli, run_jax, traced_init_patch,
                              variable_shapes)

OPTS = {"coarse_det": COARSE_CLI, "mp_det_res50": MP_CLI}


def _small(get, conf):
    def get_config(name):
        return conf.apply_overrides(get(name),
                                    conf.parse_cfg_options(OPTS[name]))
    return get_config


@pytest.fixture
def small(monkeypatch):
    """Both packages' ``get_config`` give the test sizes."""
    jget, pget = jconf.get_config, pconf.get_config
    monkeypatch.setattr(pconf, "get_config", _small(pget, pconf))
    return {"glsdet_tpu.config:get_config": _small(jget, jconf)}


def _mac_flops(model, x):
    """2 x MACs of every Conv2d and Linear over one forward, plus MP-Det's
    proxy classifier (``models/mp_head.py: proxy_scores``: per level
    position, the (C, P) similarity product and two (P, classes)
    membership products)."""
    total = []

    def hook(m, i, out):
        if isinstance(m, torch.nn.Conv2d):
            k = m.in_channels // m.groups * m.kernel_size[0] \
                * m.kernel_size[1]
        else:
            k = m.in_features
        total.append(2 * out.numel() * k)

    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.inference_mode():
        cls = model(x)[0]
    for h in hs:
        h.remove()
    proxies = getattr(model.head, "proxies", None)
    if proxies is not None:
        n_p, c = proxies.shape
        for m in cls:                      # (B, H, W, classes)
            total.append(2 * m.shape[0] * m.shape[1] * m.shape[2] * n_p
                         * (c + 2 * m.shape[3]))
    return sum(total)


@pytest.mark.parametrize("name", ["coarse_det", "mp_det_res50"])
def test_get_flops(name, small, capsys, monkeypatch):
    xla = []
    real = jax.stages.Compiled.cost_analysis

    def record(self):
        out = real(self)
        xla.append(out["flops"])
        return out

    monkeypatch.setattr(jax.stages.Compiled, "cost_analysis", record)
    capsys.readouterr()
    run_jax("get_flops", [name], **small)
    want = capsys.readouterr().out.splitlines()
    n_params, flops = get_flops.main([name, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[:2] == want[:2] and got[2].startswith("flops:  ")
    cfg = pconf.get_config(name)
    model = build_model(cfg, "cpu")
    assert n_params == sum(p.numel() for p in model.parameters())
    assert flops == _mac_flops(model, torch.zeros(1, 3, *cfg.data.img_hw))
    print(f"port / XLA flops: {flops / xla[0]:.4f}")
    assert 0.5 < flops / xla[0] < 2.0, flops / xla[0]


@pytest.mark.parametrize("name", ["coarse_det", "mp_det_res50"])
def test_full_width_parameter_counts_equal_jax(name):
    shapes = variable_shapes(jloop.build_model(jconf.get_config(name)),
                             (1, 128, 128, 3))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree.leaves(shapes["params"]))
    model = build_model(pconf.get_config(name), "cpu")
    assert sum(p.numel() for p in model.parameters()) == want


@pytest.mark.parametrize("name", ["coarse_det", "mp_det_res50"])
def test_summary_totals(name, small, capsys):
    capsys.readouterr()
    run_jax("summary", [name, "--depth", "1"], **small)
    want = capsys.readouterr().out.splitlines()[-2:]
    rows, n_params, _ = summary.main([name, "--depth", "1",
                                      "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[-2:] == want
    assert rows[0][0] == "(model)" and rows[0][3] == n_params
    assert {r[0] for r in rows[1:]} == {"backbone", "neck", "head"}
    assert sum(r[3] for r in rows[1:]) == n_params


@pytest.mark.parametrize("name", ["coarse_det", "mp_det_res50"])
def test_benchmark_lines(name, small, capsys, tmp_path):
    trace = str(tmp_path / "trace")
    common = [name, "--batch-size", "2", "--iters", "2", "--warmup", "1",
              "--device", "cpu"]
    capsys.readouterr()
    out = benchmark.main([*common, "--trace-dir", trace])
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(rf"{name}: [\d.]+ images/sec \([\d.]+ ms/img\) "
                        r"on cpu", line), line
    assert out["images_per_sec"] > 0
    with open(os.path.join(trace, f"{name}.trace.json")) as f:
        assert json.load(f)["traceEvents"]
    out = benchmark.main([*common, "--train"])
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(rf"{name} TRAIN: [\d.]+ images/sec \([\d.]+ "
                        r"ms/step, batch 2\) on cpu", line), line
    assert out["ms_per_step"] > 0


def _leaves(out):
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    return [t for o in out for t in _leaves(o)]


@pytest.mark.parametrize("with_nms", [True, False])
def test_export_round_trip(small, capsys, tmp_path, with_nms):
    path = str(tmp_path / "coarse.pt2")
    extra = ["--with-nms"] if with_nms else []
    capsys.readouterr()
    eager, again = export.main(["coarse_det", path, "--check",
                                "--device", "cpu", *extra])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == (f"exported {os.path.getsize(path)} bytes to {path} "
                        "(platforms=('cpu',))")
    a, b = _leaves(eager), _leaves(again)
    assert len(a) == len(b) == (4 if with_nms else 9)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    graph = str(torch.export.load(path).graph)
    assert ("glsdet_tpu_torch.nms_sorted" in graph) == with_nms
    if with_nms:
        # the JAX CLI's line for this config (tools/export.py --check)
        assert lines[1] == ("round-trip ok: {'boxes': (1, 100, 4), "
                            "'labels': (1, 100), 'scores': (1, 100), "
                            "'valid': (1, 100)}")
    # the program on another input: equal to the function it recorded
    cfg = pconf.get_config("coarse_det")
    fn = ModelForward(build_model(cfg, "cpu"), cfg, with_nms,
                         torch.float32)
    x = 3 * torch.randn(1, 64, 64, 3, generator=torch.Generator()
                        .manual_seed(0))
    with torch.inference_mode():
        want, got = fn(x), torch.export.load(path).module()(x)
    for u, v in zip(_leaves(want), _leaves(got)):
        assert torch.equal(u, v)


@pytest.fixture(scope="module")
def cam_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cam")
    img = str(root / "frame.png")
    write_png(img, frame(5, (90, 150)))
    ckpt = jax_checkpoint(str(root / "ckpt"), "coarse_det", COARSE_CLI,
                          seed=4)
    return str(root), img, ckpt


def test_exported_nms_keeps_what_eager_keeps(small, tmp_path):
    """With the score convolutions' biases raised every anchor is a
    candidate, so the recorded NMS operator decides what is kept."""
    cfg = pconf.get_config("coarse_det")
    model = build_model(cfg, "cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "pred" in name and name.endswith("bias") and (
                    "cls" in name or "obj" in name):
                p.fill_(3.0)
    fn = ModelForward(model, cfg, True, torch.float32).eval()
    x = 3 * torch.randn(1, 64, 64, 3, generator=torch.Generator()
                        .manual_seed(1))
    path = str(tmp_path / "nms.pt2")
    torch.export.save(torch.export.export(fn, (x,)), path)
    with torch.inference_mode():
        want, got = fn(x), torch.export.load(path).module()(x)
    for u, v in zip(_leaves(want), _leaves(got)):
        assert torch.equal(u, v)
    assert 0 < int(want["valid"].sum()) < 100


def test_export_takes_the_ema(small, tmp_path, cam_setup):
    from glsdet_tpu_torch.apis import init_detector

    ckpt = cam_setup[2]
    eager, _ = export.main(["coarse_det", str(tmp_path / "c.pt2"), "--ckpt",
                            ckpt, "--device", "cpu"])
    for use_ema in (True, False):
        _, model, _ = init_detector(
            "coarse_det", ckpt, use_ema=use_ema, device="cpu",
            options=pconf.parse_cfg_options(COARSE_CLI))
        with torch.inference_mode():      # the exported NHWC -> NCHW view
            want = model(torch.zeros(1, 64, 64, 3).permute(0, 3, 1, 2))
        same = all(torch.equal(x, y)
                   for x, y in zip(_leaves(eager), _leaves(want)))
        assert same == use_ema


@pytest.mark.parametrize("layer", [[], ["--layer", "neck", "--index", "2"]])
def test_draw_cam_matches_jax(cam_setup, capsys, monkeypatch, layer):
    import cv2

    root, img, ckpt = cam_setup
    maps = []
    resize = cv2.resize

    def record(src, *a, **kw):
        if src.dtype == np.float32:
            maps.append(src.copy())
        return resize(src, *a, **kw)

    monkeypatch.setattr(cv2, "resize", record)
    argv = ["--config", "coarse_det", "--checkpoint", ckpt, "--image", img,
            *layer, "--cfg-options", *COARSE_CLI]
    jout, pout = os.path.join(root, "j.png"), os.path.join(root, "p.png")
    capsys.readouterr()
    run_jax("draw_cam", [*argv, "--out", jout], **traced_init_patch())
    want = capsys.readouterr().out.splitlines()
    name, cam, overlay = draw_cam.main([*argv, "--out", pout,
                                        "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] and got[0].startswith(f"layer: {name}  shape:")
    assert len(maps) == 1 and cam.shape == maps[0].shape
    np.testing.assert_allclose(cam, maps[0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(read_image(pout), overlay)
    d = np.abs(overlay.astype(int) - read_image(jout))
    assert d.max() <= 3 and (d > 0).mean() <= 0.02, (d.max(),
                                                      (d > 0).mean())


@pytest.mark.parametrize("tool,argv", [
    (benchmark, ["coarse_det"]), (get_flops, ["coarse_det"]),
    (summary, ["coarse_det"]), (export, ["coarse_det", "x.pt2"]),
    (draw_cam, ["--config", "coarse_det", "--image", "x.png", "--out",
                "y.png"]),
    (test_robustness, ["coarse_det", "--ann", "a.json", "--img-root", "."]),
])
def test_the_card_is_the_default(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        tool.main(argv)


# -- the argument walk ---------------------------------------------------------

JAX_TOOLS = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "tools"))
                   if f.endswith(".py"))
NEW = {"benchmark", "get_flops", "summary", "export", "draw_cam",
       "test_robustness", "optimize_anchors", "analyze_dataset", "draw_bbox",
       "browse_dataset", "analyze_results", "analyze_logs",
       "coco_error_analysis", "confusion_matrix"}
# help texts the port words otherwise, on purpose: what it writes
HELP_CHANGED = {("benchmark", "--trace-dir"), ("export", "out_path")}


class _Parsed(Exception):
    pass


def _arguments(run, monkeypatch):
    """{flag or positional: (default, help)} of the parser that ``run``
    parses with, subcommands' as ``<sub> <flag>``."""
    seen = []

    def parse(self, *a, **kw):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args", parse)
    with pytest.raises(_Parsed):
        run()
    monkeypatch.undo()
    out = {}

    def walk(parser, prefix):
        for act in parser._actions:
            if isinstance(act, argparse._SubParsersAction):
                for sub, p in act.choices.items():
                    walk(p, f"{prefix}{sub} ")
            elif isinstance(act, argparse._HelpAction):
                continue
            for key in act.option_strings or [act.dest]:
                out[prefix + key] = (act.default, act.help)

    walk(seen[0], "")
    return out


@pytest.mark.parametrize("name", JAX_TOOLS)
def test_the_port_takes_every_flag_of_the_jax_cli(name, monkeypatch):
    import importlib

    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    mod = jax_cli(name)
    want = _arguments(mod.main, monkeypatch)
    port = importlib.import_module(f"glsdet_tpu_torch.tools.{name}")
    got = _arguments(lambda: port.main([]), monkeypatch)
    missing = sorted(set(want) - set(got))
    assert want and not missing, missing
    for key, (default, text) in want.items():
        assert got[key][0] == default, (key, got[key][0], default)
        if name in NEW and (name, key) not in HELP_CHANGED:
            assert got[key][1] == text, (key, got[key][1], text)


@pytest.mark.parametrize("name", sorted(NEW))
def test_help(name, capsys):
    import importlib

    port = importlib.import_module(f"glsdet_tpu_torch.tools.{name}")
    with pytest.raises(SystemExit) as e:
        port.main(["--help"])
    assert e.value.code == 0 and "usage:" in capsys.readouterr().out
