"""Port parity: the coarse ``YOLOXDetector`` with each of the six
``variant`` plugins of the zoo (``lsk``, ``evc``, ``se``, ``mscam``,
``nonlocal``, ``fg_fpn``) and an unknown variant string, against the JAX
package's, ``apis.Detector`` serving a variant against the JAX facade,
and ``CSPDarknet(out_indices=)`` with the stem, the backbone knob FFA sets,
on the CPU.

YOLOX-nano at 64x64 (128x128 for ``nonlocal``, whose 4x4 patches must
divide every level); flax weights with jittered constant leaves
(``torch_port_util.flax_vars``), loaded with strict=True; each output map
at rtol = atol = 1e-4 (``check_detector``).  The facade comparison uses
tests/test_torch_apis.py's setup (``DET_OPTS``, noise frames of 96x160
plus one of 120x90): detections matched both ways, >= 95%, same label,
IoU > 0.99 and scores within 1e-4 (tests/test_torch_two_stage.py:
``_matched``).
"""

import jax
import numpy as np
import pytest
import torch

import glsdet_tpu.apis as japis
from glsdet_tpu.config import apply_overrides as japply
from glsdet_tpu.config import get_config as jget_config
from glsdet_tpu.models import CSPDarknet as JCSP
from glsdet_tpu.models import YOLOXDetector as JYOLOX
from glsdet_tpu.train.loop import build_model as jbuild_model
from glsdet_tpu_torch import apis
from glsdet_tpu_torch.models import YOLOXDetector
from glsdet_tpu_torch.models.csp_darknet import CSPDarknet
from glsdet_tpu_torch.utils.flax_import import state_dict_from_flax
from test_torch_apis import DET_OPTS
from test_torch_two_stage import FRAME, _matched
from test_torch_variants import assert_pairs, run_pair, x
from torch_port_util import check_detector, flax_vars, rand_nhwc


@pytest.mark.parametrize("variant", ["lsk", "evc", "se", "mscam",
                                     "nonlocal", "fg_fpn"])
def test_yolox_variant_matches_flax(variant):
    # PatchNonLocal(patch=4) needs every level a multiple of 4: 128 px
    side = 128 if variant == "nonlocal" else 64
    check_detector(JYOLOX(num_classes=10, phi="nano", variant=variant),
                   YOLOXDetector(10, "nano", variant,
                                 generator=torch.Generator().manual_seed(0)),
                   rand_nhwc((2, side, side, 3), seed=1))


def test_unknown_variant_builds_the_plain_detector():
    """The JAX detector matches no branch for an unknown string and
    builds plain YOLOX; the port does the same: its parameter names are
    the plain detector's, and the JAX variables load into it strictly."""
    plain = YOLOXDetector(10, "nano", generator=torch.Generator())
    other = YOLOXDetector(10, "nano", "yolox6",
                          generator=torch.Generator())
    assert list(plain.state_dict()) == list(other.state_dict())
    jm = JYOLOX(num_classes=10, phi="nano", variant="yolox6")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 64, 64, 3)), train=False))
    other.load_state_dict(state_dict_from_flax(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)), strict=True)


def test_detector_serves_a_variant_as_the_jax_facade(tmp_path):
    """``Detector("coarse_det", options={"model.variant": "mscam"})``
    against the JAX facade on the same weights."""
    opts = {**DET_OPTS, "model.variant": "mscam"}
    cfg = japply(jget_config("coarse_det"), dict(opts))
    model = jbuild_model(cfg)
    v = flax_vars(model, np.zeros((1, 64, 64, 3), np.float32))
    jd = japis.Detector.__new__(japis.Detector)
    jd.cfg, jd.score_thr = cfg, cfg.eval.score_thr
    jd.class_names = list(apis.VISDRONE_CLASSES)
    jd._raw_apply = model.apply
    jd._variables = jax.device_put(v)
    jd._set_fwd(model.apply)
    torch.save(state_dict_from_flax(v), tmp_path / "w.pt")
    td = apis.Detector("coarse_det", str(tmp_path / "w.pt"), options=opts,
                       device="cpu")
    assert hasattr(td._net, "mscam2")
    rs = np.random.RandomState(0)
    imgs = [rs.randint(0, 256, (*FRAME, 3), np.uint8) for _ in range(3)]
    imgs.append(rs.randint(0, 256, (120, 90, 3), np.uint8))
    want = jd.detect_batch([im.copy() for im in imgs])
    got = td.detect_batch([im.copy() for im in imgs])
    for g, w in zip(got, want):
        assert len(g["boxes"]) > 0
        assert _matched(g, w) >= 0.95 and _matched(w, g) >= 0.95


# -- the backbone knob that FFA sets -----------------------------------------

@pytest.mark.parametrize("out_indices", [(0, 1, 2, 3, 4), (1, 2, 3, 4)])
def test_csp_darknet_out_indices_matches_flax(out_indices):
    """``CSPDarknet(out_indices=)``, the stem (index 0) included; FFA
    takes (1, 2, 3, 4)."""
    assert_pairs(run_pair(
        JCSP(depth_mult=0.33, width_mult=0.25, depthwise=True,
             out_indices=out_indices),
        CSPDarknet(0.33, 0.25, True, out_indices=out_indices),
        [x((2, 64, 64, 3))]))
