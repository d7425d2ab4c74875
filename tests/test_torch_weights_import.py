"""Reference torch checkpoints into the port (``utils/torch_import.py``,
``tools/import_torch_weights.py``) against the JAX package's import.

- the reverse-naming helper of ``tests/torch_port_util.py`` (also in
  ``chip_smoke.py``) is the inverse of the JAX package's
  ``_map_yolox_drone`` / ``_map_mpdet`` on every key of the port's models;
- ``convert_yolox_drone`` / ``convert_mpdet`` equal ``state_dict_from_flax``
  of the JAX conversions of the same reference state dicts, with the same
  report counts, and fail where the JAX ones fail (``strict``);
- the CLI's output loads strictly into ``init_detector``,
  ``TwoStageDetector`` and ``load_weights``; mmcv wrappers unwrap; the
  BoIW buffers become the state ``train()`` resumes with; ``--no-strict``
  keeps the seeded initialisation where the checkpoint is silent.
"""


import numpy as np
import pytest
import torch

from glsdet_tpu_torch.config import apply_overrides, get_config
from glsdet_tpu_torch.models.build import build_model
from glsdet_tpu_torch.tools import import_torch_weights
from glsdet_tpu_torch.utils import torch_import
from glsdet_tpu_torch.utils.flax_import import state_dict_from_flax
from torch_port_util import (COARSE_OPTS, MP_OPTS, mmdet_key,
                             reference_checkpoint, yolox_drone_key)

CONFIGS = {
    "yolox_nano": ("coarse_det", {"model.phi": "nano"}, "yolox"),
    "yolox_s": ("coarse_det", {}, "yolox"),
    "mpdet_r18": ("mp_det_res50", {"model.depth": 18}, "mpdet"),
    "mpdet_r50": ("mp_det_res50", {}, "mpdet"),
    "gfl_r18": ("gfl_res50", {"model.depth": 18}, "mpdet"),
}


def port_model(name):
    cfg_name, opts, _ = CONFIGS[name]
    return build_model(apply_overrides(get_config(cfg_name), dict(opts)),
                       device="cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reverse_naming_inverts_the_jax_rewrites(name):
    from glsdet_tpu.utils import torch_import as jti

    family = CONFIGS[name][2]
    fwd, rev = ((jti._map_yolox_drone, yolox_drone_key) if family == "yolox"
                else (jti._map_mpdet, mmdet_key))
    keys = list(port_model(name).state_dict())
    refs = [rev(k) for k in keys]
    assert len(set(refs)) == len(keys)
    for k, r in zip(keys, refs):
        got = fwd(r)
        assert k == got or (isinstance(got, tuple) and k in got), (k, r, got)


def jax_template(cfg_name, opts):
    """The JAX model's initial variables (``PRNGKey(0)``): each config's
    init is compiled once for the module, and every call gets its own
    copy of the arrays."""
    import jax

    key = (cfg_name, tuple(sorted(opts.items())))
    if key not in _TEMPLATES:
        _TEMPLATES[key] = _jax_init(cfg_name, opts)
    return jax.tree.map(np.copy, _TEMPLATES[key])


_TEMPLATES = {}


def _jax_init(cfg_name, opts):
    import jax
    import jax.numpy as jnp

    from glsdet_tpu.config import apply_overrides as japply
    from glsdet_tpu.config import get_config as jget
    from glsdet_tpu.train.loop import build_model as jbuild

    model = jbuild(japply(jget(cfg_name), dict(opts)))
    tpl = jax.jit(lambda r: model.init(r, jnp.zeros((1, 64, 64, 3)),
                                       train=False))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, tpl)


def seeded_reference(name, seed=3, boiw=None):
    """A reference-named checkpoint of ``name``'s port model with every
    tensor drawn from ``seed`` (so no two tensors are equal)."""
    model = port_model(name)
    g = torch.Generator().manual_seed(seed)
    sd = {k: (torch.randn(v.shape, generator=g) if v.is_floating_point()
              else torch.zeros_like(v)) for k, v in model.state_dict().items()}
    return model, sd, reference_checkpoint(sd, CONFIGS[name][2], boiw=boiw)


def flat(ref):
    return ref["state_dict"] if "state_dict" in ref else ref


@pytest.mark.parametrize("name", ["yolox_nano", "mpdet_r18", "gfl_r18"])
def test_convert_equals_state_dict_from_flax_of_jax(name):
    from glsdet_tpu.utils import torch_import as jti

    cfg_name, opts, family = CONFIGS[name]
    model, sd, ref = seeded_reference(name)
    state = flat(ref)
    if family == "mpdet":
        state["bbox_head._embedding"] = torch.randn(3, 10, 256)
        state["bbox_head._pos_embedding_ptr"] = torch.zeros(3, dtype=torch.long)
        state["bbox_head._proxies_prob"] = torch.rand(5)
    convert = (torch_import.convert_yolox_drone if family == "yolox"
               else torch_import.convert_mpdet)
    jconvert = (jti.convert_yolox_drone if family == "yolox"
                else jti.convert_mpdet)
    got, report = convert(state, model)
    jvars, jreport = jconvert({k: v.numpy() for k, v in state.items()},
                              jax_template(cfg_name, opts))
    want = state_dict_from_flax(jvars)
    assert set(got) == set(want) == set(model.state_dict())
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], sd[k]), k
    for field in ("converted", "skipped", "unmatched", "missing"):
        assert len(getattr(report, field)) == len(getattr(jreport, field))
    assert report.summary() == jreport.summary()
    assert sorted(report.skipped) == sorted(jreport.skipped)
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("fault", ["unknown_key", "missing_key", "shape",
                                   "not_in_model"])
@pytest.mark.parametrize("name", ["yolox_nano", "mpdet_r18"])
def test_strict_fails_where_jax_fails(name, fault):
    from glsdet_tpu.utils import torch_import as jti

    cfg_name, opts, family = CONFIGS[name]
    model, _, ref = seeded_reference(name)
    state = dict(flat(ref))
    first = next(k for k in state if k.endswith("conv.weight")
                 or k.endswith("conv1.weight"))
    if fault == "unknown_key":
        state["something.else.weight"] = torch.zeros(3)
    elif fault == "missing_key":
        del state[first]
    elif fault == "shape":
        state[first] = torch.zeros(1, 1, 1, 1)
    else:
        extra = ("head.cls_preds.9.weight" if family == "yolox"
                 else "bbox_head.scales.9.scale")
        state[extra] = torch.zeros(())
    convert = (torch_import.convert_yolox_drone if family == "yolox"
               else torch_import.convert_mpdet)
    jconvert = (jti.convert_yolox_drone if family == "yolox"
                else jti.convert_mpdet)
    err = ValueError if fault == "shape" else KeyError
    with pytest.raises(err):
        jconvert({k: v.numpy() for k, v in state.items()},
                 jax_template(cfg_name, opts))
    with pytest.raises(err):
        convert(state, model)
    if fault != "shape":
        _, report = convert(state, model, strict=False)
        _, jreport = jconvert({k: v.numpy() for k, v in state.items()},
                              jax_template(cfg_name, opts), strict=False)
        assert report.summary() == jreport.summary()
        assert report.unmatched == jreport.unmatched


def run_cli(tmp_path, name, ckpt, *extra):
    cfg_name, opts, family = CONFIGS[name]
    src, dst = str(tmp_path / "ref.pth"), str(tmp_path / "out.pt")
    torch.save(ckpt, src)
    argv = [src, dst, "--arch", family, "--config", cfg_name,
            "--cfg-options", *[f"{k}={v}" for k, v in opts.items()], *extra]
    out, report = import_torch_weights.main(argv)
    return dst, out, report


@pytest.mark.parametrize("wrapper", ["bare", "model"])
def test_cli_yolox_round_trip_loads_strictly(tmp_path, wrapper, capsys):
    from glsdet_tpu_torch import apis

    model, sd, ref = seeded_reference("yolox_nano")
    if wrapper == "model":
        ref = {"model": ref, "epoch": 3}
    dst, out, report = run_cli(tmp_path, "yolox_nano", ref)
    printed = capsys.readouterr().out
    assert report.summary() in printed and "wrote" in printed
    assert not report.missing and not report.unmatched
    loaded = torch.load(dst, weights_only=True)
    assert set(loaded) == set(sd)
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k
    _, served, got = apis.init_detector("coarse_det", dst,
                                        options={"model.phi": "nano"},
                                        device="cpu")
    for k in sd:
        assert torch.equal(got[k], sd[k]), k


def test_cli_mpdet_mmcv_wrapper_with_boiw(tmp_path, capsys):
    from glsdet_tpu_torch.train.boiw import init_boiw
    from glsdet_tpu_torch.train.loop import (build_optimizer, load_weights,
                                             make_state_template)

    cfg = apply_overrides(get_config("mp_det_res50"), {"model.depth": 18})
    boiw = init_boiw(torch.Generator().manual_seed(5), cfg.model.num_classes,
                     cfg.model.num_words, cfg.model.feat_channels,
                     cfg.model.proxies_list, device="cpu")
    boiw = boiw._replace(ptr=torch.arange(len(boiw.ptr)))
    model, sd, ref = seeded_reference("mpdet_r18", boiw=boiw)
    assert set(ref) == {"meta", "state_dict"}
    dst, out, report = run_cli(tmp_path, "mpdet_r18", ref)
    assert "extracted BoIW" in capsys.readouterr().out
    assert set(out) == {"model", "boiw"}
    assert {"bbox_head._embedding", "bbox_head._pos_embedding_ptr",
            "bbox_head._proxies_prob",
            "bbox_head.integral.project"} <= set(report.skipped)
    # load_weights (train.load_from): every tensor and the dictionary
    target = port_model("mpdet_r18")
    state = make_state_template(cfg, target,
                                build_optimizer(cfg, 10, target),
                                torch.Generator())
    state, n, skipped = load_weights(dst, state)
    assert skipped == []
    for k, v in target.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for f in ("embedding", "ptr", "proxies_prob"):
        assert torch.equal(getattr(state.boiw, f), getattr(boiw, f)), f
    # init_detector serves the converted weights (the EMA seeded from them)
    from glsdet_tpu_torch import apis

    _, _, got = apis.init_detector("mp_det_res50", dst,
                                   options={"model.depth": 18},
                                   device="cpu")
    for k in sd:
        assert torch.equal(got[k], sd[k]), k


def test_cli_no_strict_keeps_the_seeded_init(tmp_path, capsys):
    model, sd, ref = seeded_reference("yolox_nano")
    dropped = [k for k in ref if k.startswith("head.obj_preds.")]
    for k in dropped:
        del ref[k]
    ref["extra.thing"] = torch.zeros(2)
    with pytest.raises(KeyError):
        run_cli(tmp_path, "yolox_nano", ref)
    dst, out, report = run_cli(tmp_path, "yolox_nano", ref, "--no-strict")
    printed = capsys.readouterr().out
    assert "unmatched: extra.thing" in printed and "left at init" in printed
    assert report.unmatched == ["extra.thing"]
    assert len(report.missing) == len(dropped)
    seeded = port_model("yolox_nano").state_dict()
    loaded = torch.load(dst, weights_only=True)
    port_model("yolox_nano").load_state_dict(loaded, strict=True)
    for k in seeded:
        want = seeded[k] if k.startswith("head.obj_pred") else sd[k]
        if k.endswith("num_batches_tracked"):
            want = seeded[k]
        assert torch.equal(loaded[k], want), k


def test_two_stage_facade_from_converted_files(tmp_path):
    """TwoStageDetector built from the CLI's files gives the detections
    of one built from the port's own state-dict files."""
    from glsdet_tpu_torch.apis import TwoStageDetector

    coarse_opts = {k: v for k, v in COARSE_OPTS.items()
                   if k != "model.dtype"}
    mp_opts = {k: v for k, v in MP_OPTS.items() if k != "model.dtype"}
    c_cfg = apply_overrides(get_config("coarse_det"), coarse_opts)
    m_cfg = apply_overrides(get_config("mp_det_res50"), mp_opts)
    coarse = build_model(c_cfg, device="cpu")
    mp = build_model(m_cfg, device="cpu")
    own = (str(tmp_path / "c.pt"), str(tmp_path / "m.pt"))
    torch.save(coarse.state_dict(), own[0])
    torch.save(mp.state_dict(), own[1])
    conv = []
    for i, (sd, family, cfg_name, opts) in enumerate((
            (coarse.state_dict(), "yolox", "coarse_det", coarse_opts),
            (mp.state_dict(), "mpdet", "mp_det_res50", mp_opts))):
        src, dst = str(tmp_path / f"r{i}.pth"), str(tmp_path / f"o{i}.pt")
        torch.save(reference_checkpoint(sd, family), src)
        import_torch_weights.main(
            [src, dst, "--arch", family, "--config", cfg_name,
             "--cfg-options", *[f"{k}={v}" for k, v in opts.items()
                                if k != "eval.mosaic_buckets"
                                and k != "data.img_hw"]])
        conv.append(dst)
    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 255, (64, 96, 3), np.uint8) for _ in range(2)]
    dets = []
    for paths in (own, conv):
        det = TwoStageDetector("coarse_det", paths[0], "mp_det_res50",
                               paths[1], coarse_options=coarse_opts,
                               mp_options=mp_opts, device="cpu")
        dets.append(det.detect_batch(frames))
    for a, b in zip(*dets):
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
