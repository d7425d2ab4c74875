"""Port parity: int8 two-stage serving (``quant8="static"`` and
``quant8=True``), on the CPU.

The fixture of tests/test_torch_two_stage.py: YOLOX-nano and MPDet depth
18 with the same flax weights, coarse input 64x64, buckets (128, 256),
three RandomState(0) noise frames of 96x160, coarse threshold 1e-4, the
JAX pipeline painting with the Pallas kernel in interpret mode, both in
float32 with one packing thread.

Static int8: the JAX package's float pipeline calibrates, and its scales
feed both int8 pipelines, so both quantize with the same scales.  The
port's own ``calibrate_int8`` must give the JAX package's keys, with
values within 1%: the captured mosaic inputs can differ where UFP packing
floors a coordinate differently (ROADMAP.md §C, "Packing floors
coordinates").

Whole ``run_batch`` outputs are compared by matching, >= 95% both ways,
but at int8 tolerances (same label, IoU > 0.5, scores within 0.1) instead
of tests/test_torch_two_stage.py's float ones (IoU > 0.99, 1e-4).  The
float32 layers ahead of the first int8 layer (the coarse resize, the
stems) sum in another order than XLA's, so a few int8 codes flip at
rounding boundaries, and in an int8 chain each flip moves the next
convolution's 9 * C outputs by a fraction of a code, so flips multiply
layer by layer (tests/test_torch_quant_static.py; the JAX package's own
jitted and eager int8 MPDet-18 forwards differ by up to 8% of the output
maximum).  Measured at this size: 66-80% of the port's int8 detections
match the JAX package's at IoU > 0.9 and scores within 0.01, about the
share at which the JAX package's int8 detections match its own float ones,
and 93-99% at IoU > 0.5 and 0.1.  The code-level parity is held
where the chain starts from the same values: tests/test_torch_quant_static.py
and tests/test_torch_int8_conv.py.  Here the checks are that both modes
run their int8 models end to end, the calibration keys, and that the
detections are the reference's up to that noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.eval.two_stage import TwoStagePipeline as JPipeline
from glsdet_tpu.models import MPDet as JMPDet
from glsdet_tpu.models import YOLOXDetector as JYOLOX
from glsdet_tpu_torch.eval.two_stage import TwoStagePipeline
from glsdet_tpu_torch.models import MPDet, YOLOXDetector
from glsdet_tpu_torch.ops.quant import DynamicQuantConv2d
from glsdet_tpu_torch.ops.quant_static import Int8MPHead, QConvNormAct
from test_torch_two_stage import BUCKETS, COARSE_HW, FRAME
from torch_port_util import flax_vars, load_flax

KW = dict(coarse_score_thr=1e-4, mosaic_buckets=BUCKETS, max_batch=4)


@pytest.fixture(scope="module")
def setup():
    jc, jm = JYOLOX(num_classes=10, phi="nano"), JMPDet(num_classes=10,
                                                        depth=18)
    x = np.zeros((1, 64, 64, 3), np.float32)
    cvars = flax_vars(jc, x)
    mvars = flax_vars(jm, x, perturb=False)
    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 256, (*FRAME, 3), np.uint8) for _ in range(3)]

    def jpipe(**kw):
        return JPipeline(lambda v, im: jc.apply(v, im, train=False),
                         lambda v, im: jm.apply(v, im, train=False),
                         COARSE_HW, coarse_vars=jax.device_put(cvars),
                         mp_vars=jax.device_put(mvars),
                         mosaic_dtype=jnp.float32, painter="pallas",
                         pack_mode="bucket-fit", pack_threads=1, **KW, **kw)

    def tpipe(**kw):
        g = torch.Generator().manual_seed(0)
        return TwoStagePipeline(
            load_flax(YOLOXDetector(10, "nano", generator=g), cvars),
            load_flax(MPDet(10, 18, generator=g), mvars), COARSE_HW,
            pack_mode="bucket-fit", pack_threads=1, device="cpu", **KW,
            **kw)

    scales = jpipe().calibrate_int8([f.copy() for f in frames])
    return jpipe, tpipe, frames, scales


def _matched(a, b):
    """Share of a's detections with a partner in b: same label, IoU >
    0.5 and |score difference| < 0.1 (int8 tolerances, module doc)."""
    if not len(a["boxes"]):
        return 1.0
    hits = 0
    for box, s, lab in zip(a["boxes"], a["scores"], a["labels"]):
        o = b["boxes"][(b["labels"] == lab) & (np.abs(b["scores"] - s) < 0.1)]
        lt = np.maximum(o[:, :2], box[:2])
        rb = np.minimum(o[:, 2:], box[2:])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
        area = lambda x: np.prod(x[..., 2:] - x[..., :2], axis=-1)  # noqa
        iou = inter / np.maximum(area(o) + area(box) - inter, 1e-9)
        hits += int((iou > 0.5).any())
    return hits / len(a["boxes"])


def _run_both(jpipe, tpipe, frames):
    want = jpipe.run_batch([f.copy() for f in frames])
    h = tpipe.submit_batch([f.copy() for f in frames])
    tpipe.dispatch_mosaics(h)
    assert len(h.pending) >= 1                    # stage 2 ran
    got = tpipe.collect_batch(h)
    tpipe.close()
    total = 0
    for g, w in zip(got, want):
        total += len(g["boxes"])
        assert _matched(g, w) >= 0.95 and _matched(w, g) >= 0.95
    assert total > 0


def test_calibrate_int8_gives_the_jax_keys(setup):
    _, tpipe, frames, (jc, jm) = setup
    pipe = tpipe(quant8="static")
    tc, tm = pipe.calibrate_int8([f.copy() for f in frames])
    pipe.close()
    for got, want in ((tc, jc), (tm, jm)):
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 0.01 * want[k], k


def _kinds(model):
    return {type(m) for m in model.modules()}


def test_static_int8_run_batch_matches(setup):
    jpipe, tpipe, frames, scales = setup
    pipe = tpipe(quant8="static", act_scales=scales)
    assert QConvNormAct in _kinds(pipe.coarse_net)
    assert {QConvNormAct, Int8MPHead} <= _kinds(pipe.mp_net)
    assert QConvNormAct not in _kinds(pipe.mp)       # float model kept
    _run_both(jpipe(quant8="static", act_scales=scales), pipe, frames)


def test_dynamic_int8_run_batch_matches(setup):
    jpipe, tpipe, frames, _ = setup
    pipe = tpipe(quant8=True)
    assert DynamicQuantConv2d in _kinds(pipe.coarse_net)
    assert DynamicQuantConv2d in _kinds(pipe.mp_net)
    _run_both(jpipe(quant8=True), pipe, frames)


def test_static_without_scales_serves_the_float_models(setup):
    _, tpipe, _, _ = setup
    pipe = tpipe(quant8="static")
    assert pipe.coarse_net is pipe.coarse and pipe.mp_net is pipe.mp
    pipe.close()
    with pytest.raises(ValueError):
        tpipe(quant8="dynamic")
