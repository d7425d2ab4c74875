"""The port imports neither JAX nor the JAX package.

Every module of ``glsdet_tpu_torch`` is imported in a fresh interpreter
where ``sys.modules["jax"]`` and ``sys.modules["glsdet_tpu"]`` are None,
so any import of either (a jax-free module of the JAX package included)
raises there."""

import json
import os
import pkgutil
import subprocess
import sys

import glsdet_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["glsdet_tpu"] = None
import glsdet_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    glsdet_tpu_torch.__path__, "glsdet_tpu_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "flax", "glsdet_tpu"))
print(json.dumps([len(names), bad]))
"""


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
                 "glsdet_tpu_torch.tools.ckpt_tool"):
        assert name in modules
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    n, bad = json.loads(out.stdout.splitlines()[-1])
    assert bad == [] and n == len(modules), (n, bad)


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
