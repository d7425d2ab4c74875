"""Port parity: the config system (``glsdet_tpu_torch/config``), a copy of
the JAX package's.  Every registered config equal by
``dataclasses.asdict``; ``get_config``, ``apply_overrides`` and
``parse_cfg_options`` giving the same results and the same errors."""

import dataclasses

import pytest

import glsdet_tpu.config as jcfg
import glsdet_tpu_torch.config as tcfg


def test_the_same_configs_are_registered():
    assert tcfg.list_configs() == jcfg.list_configs()
    assert len(tcfg.list_configs()) >= 12


@pytest.mark.parametrize("name", jcfg.list_configs())
def test_registered_config_equal(name):
    t, j = tcfg.get_config(name), jcfg.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.name == j.name == name


def test_default_config_equal_and_square_packing():
    t, j = tcfg.Config(), jcfg.Config()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.eval.pack_mode == "square" and t.eval.bucket_policy == "image"


@pytest.mark.parametrize("name", ["coarse_det.py", "configs/x/mp_det_res50.py",
                                  "yolox_nano_300e"])
def test_get_config_resolves_paths_alike(name):
    assert (dataclasses.asdict(tcfg.get_config(name))
            == dataclasses.asdict(jcfg.get_config(name)))


def _error(fn, *args):
    with pytest.raises(Exception) as e:
        fn(*args)
    return type(e.value), str(e.value)


def test_unknown_config_raises_alike():
    assert _error(tcfg.get_config, "nope") == _error(jcfg.get_config, "nope")


PAIRS = [
    [],
    ["train.base_lr=0.02", "data.batch_size=16"],
    ["data.img_hw=(320, 480)", "eval.mosaic_buckets=[512, 1024]"],
    ["train.work_dir=work_dirs/x", "model.variant=lsk",
     "eval.pack_mode=bucket-fit"],
    ["model.remat=False", "train.resume=", "x=1=2"],
]


@pytest.mark.parametrize("pairs", PAIRS)
def test_parse_cfg_options_equal(pairs):
    assert tcfg.parse_cfg_options(pairs) == jcfg.parse_cfg_options(pairs)


OVERRIDES = [
    {"train.base_lr": 0.02, "data.batch_size": 16},
    {"data.img_hw": [320, 480], "eval.mosaic_buckets": (512, 1024)},
    {"model.phi": "nano", "eval.coarse_score_thr": 1e-4,
     "eval.pack_mode": "bucket-fit", "eval.bucket_policy": "chunk-max"},
    {"train.epochs": 3.0, "model.num_classes": "3", "train.ema": 0},
    {"model.proxies_list": [4, 4, 4], "train.multiscale_sizes": [320, 352]},
]


@pytest.mark.parametrize("options", OVERRIDES)
@pytest.mark.parametrize("name", ["coarse_det", "mp_det_res50"])
def test_apply_overrides_equal(name, options):
    t = tcfg.apply_overrides(tcfg.get_config(name), dict(options))
    j = jcfg.apply_overrides(jcfg.get_config(name), dict(options))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("options", [
    {"model.nope": 1},
    {"nope.lr": 1},
    {"train.epochs": "many"},
])
def test_apply_overrides_raises_alike(options):
    assert (_error(tcfg.apply_overrides, tcfg.get_config("coarse_det"),
                   options)
            == _error(jcfg.apply_overrides, jcfg.get_config("coarse_det"),
                      options))
