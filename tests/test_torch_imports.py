"""The port imports neither JAX nor the JAX package.

Every module of ``glsdet_tpu_torch`` is imported in a fresh interpreter
where ``sys.modules["jax"]`` and ``sys.modules["glsdet_tpu"]`` are None,
so any import of either (a jax-free module of the JAX package included)
raises there.  ``tensorstore``, ``orbax``, ``zstandard``, OpenCV, PIL,
matplotlib and PyAV are blocked the same way (the GPU machine has none of
them), and no source of the port names the last four even in a function
that only imports them when called.  The orbax reader
reads the committed JAX checkpoint fixtures there (the ``TrainState`` and
the two-stage archive)."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

import glsdet_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ("jax", "flax", "glsdet_tpu", "tensorstore", "orbax",
           "zstandard", "cv2", "PIL", "matplotlib", "av")
PROBE = """
import importlib, json, pkgutil, sys
BLOCKED = %r
for name in BLOCKED:
    sys.modules[name] = None
import glsdet_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    glsdet_tpu_torch.__path__, "glsdet_tpu_torch."))
for name in names:
    importlib.import_module(name)
import tempfile
from glsdet_tpu_torch.serve import load_archive
from glsdet_tpu_torch.utils.orbax_read import read_orbax
tree = read_orbax("tests/torch_fixtures/orbax/trainstate")
with tempfile.TemporaryDirectory() as tmp:
    _, dirs = load_archive("tests/torch_fixtures/orbax/two_stage.gtar", tmp)
    mp = sorted(read_orbax(dirs["mp"]))
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in BLOCKED)
print(json.dumps([len(names), bad, sorted(tree), mp]))
""" % (BLOCKED,)


# the workflow's commands (python -m glsdet_tpu_torch.tools.<name>)
TOOLS = ("print_config", "convert_datasets", "train", "build_ufp_dataset",
         "test", "get_map", "eval_metric", "merge_results",
         "ufp_eval_from_txt", "predict", "serve", "visdrone_e2e", "common",
         # the analysis and robustness commands
         "benchmark", "get_flops", "summary", "export", "draw_cam",
         "test_robustness", "optimize_anchors", "analyze_dataset",
         "draw_bbox", "browse_dataset", "analyze_results", "analyze_logs",
         "coco_error_analysis", "confusion_matrix",
         # the multi-process launcher
         "dist_launch")


def _importers(pattern):
    """The port's sources (relative paths) with a line matching
    ``pattern``."""
    import re

    pat = re.compile(pattern, re.M)
    pkg = os.path.dirname(glsdet_tpu_torch.__file__)
    bad = []
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    if pat.search(f.read()):
                        bad.append(os.path.relpath(
                            os.path.join(dirpath, name), pkg))
    return bad


def test_every_port_module_imports_without_jax():
    modules = [m.name for m in pkgutil.walk_packages(
        glsdet_tpu_torch.__path__, "glsdet_tpu_torch.")]
    # the serving facades, the carried-over host modules and the data
    # pipeline are among them
    for name in ("glsdet_tpu_torch.apis", "glsdet_tpu_torch.serve",
                 "glsdet_tpu_torch.config.core",
                 "glsdet_tpu_torch.eval.fusion",
                 "glsdet_tpu_torch.models.build",
                 "glsdet_tpu_torch.data.image_io",
                 "glsdet_tpu_torch.data.video",
                 "glsdet_tpu_torch.data.video_container",
                 "glsdet_tpu_torch.data.augment",
                 "glsdet_tpu_torch.data.coco",
                 "glsdet_tpu_torch.data.visdrone",
                 "glsdet_tpu_torch.data.wrappers",
                 "glsdet_tpu_torch.data.device_color",
                 "glsdet_tpu_torch.data.device_geom",
                 "glsdet_tpu_torch.data.loader",
                 "glsdet_tpu_torch.train.loop",
                 "glsdet_tpu_torch.train.state",
                 "glsdet_tpu_torch.eval.coco_eval",
                 "glsdet_tpu_torch.eval.voc_map",
                 "glsdet_tpu_torch.eval.ignore",
                 "glsdet_tpu_torch.eval.tta",
                 "glsdet_tpu_torch.eval.runner",
                 "glsdet_tpu_torch.tools.ufpmp_det_eval",
                 "glsdet_tpu_torch.data.uavdt",
                 "glsdet_tpu_torch.data.voc",
                 "glsdet_tpu_torch.utils.torch_import",
                 "glsdet_tpu_torch.utils.observe",
                 "glsdet_tpu_torch.tools.import_torch_weights",
                 "glsdet_tpu_torch.tools.ckpt_tool",
                 "glsdet_tpu_torch.models.variants.attention",
                 "glsdet_tpu_torch.models.variants.batchformer",
                 "glsdet_tpu_torch.models.variants.blocks",
                 "glsdet_tpu_torch.models.variants.cfp",
                 "glsdet_tpu_torch.models.variants.dyhead",
                 "glsdet_tpu_torch.models.variants.ffa",
                 "glsdet_tpu_torch.models.variants.ffa_model",
                 "glsdet_tpu_torch.models.variants.lsk",
                 "glsdet_tpu_torch.models.variants.necks",
                 "glsdet_tpu_torch.native",
                 "glsdet_tpu_torch.utils.orbax_read",
                 "glsdet_tpu_torch.utils.flax_import",
                 "glsdet_tpu_torch.utils.plot",
                 "glsdet_tpu_torch.data.corruptions",
                 "glsdet_tpu_torch.parallel",
                 "glsdet_tpu_torch.parallel.mesh",
                 *(f"glsdet_tpu_torch.tools.{t}" for t in TOOLS)):
        assert name in modules
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    n, bad, sections, mp = json.loads(out.stdout.splitlines()[-1])
    assert bad == [] and n == len(modules), (n, bad)
    assert sections == ["batch_stats", "boiw", "ema_params", "opt_state",
                        "params", "rng", "step"]
    assert mp == ["batch_stats", "boiw", "params"]


def test_no_port_module_imports_opencv():
    """The GPU machine has no OpenCV: no source of the port imports cv2
    (the probe above imports every module; a lazy import inside a
    function would only fail when called, so the sources are read)."""
    import re

    pat = re.compile(r"^\s*(import cv2|from cv2 )", re.M)
    pkg = os.path.dirname(glsdet_tpu_torch.__file__)
    bad = []
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    if pat.search(f.read()):
                        bad.append(os.path.relpath(
                            os.path.join(dirpath, name), pkg))
    assert bad == []


@pytest.mark.parametrize("library", ["PIL", "matplotlib", "av"])
def test_no_port_module_imports_a_library_the_card_machine_lacks(library):
    """Nor PIL, matplotlib or PyAV (the JAX package's predict CLI reads
    images with PIL, its analysis tools plot with matplotlib; video is
    read without PyAV as without OpenCV)."""
    assert _importers(rf"^\s*(import {library}\b|from {library}[. ])") \
        == []
