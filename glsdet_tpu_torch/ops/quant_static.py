"""Static-scale W8A8 inference with int8-resident activations (PTQ), the
counterpart of ``glsdet_tpu/ops/quant_static.py``.

1. **Calibrate** (:func:`calibrate_scales`): forward hooks record each
   eligible module's input and output absmax over a few batches ->
   ``{module_path: absmax / 127}``, with the JAX package's keys (flax
   module paths, ``/``-separated, plus ``.in`` / ``.out``) and its
   ``glsdet-int8-scales-v1`` JSON (:func:`save_scales`/:func:`load_scales`),
   so a scales file written by either package loads in the other.
2. **Serve** (:func:`quantize_static`): a copy of the float model in which
   the eligible modules are replaced, once, by quantized modules built from
   the float modules and the scales:

   - ``ResNet`` at depth >= 50 -> :class:`Int8ResNet`, an explicit int8
     dataflow (int8 tensors between every conv and block, BN folded);
   - ``MPHead`` -> :class:`Int8MPHead` and ``GFLHead`` ->
     :class:`Int8GFLHead`: int8 GN towers whose GroupNorm -> ReLU ->
     requant step is the CUDA kernel of ``ops/gn_kernel.py`` on the card
     (8 launches per level: 40 per batch at five levels); the predictor
     convs and the proxy scores stay full precision;
   - otherwise per module: ``ConvNormAct``/``ResNetConv`` with groups 1 and
     in/out >= ``min_channels`` -> :class:`QConvNormAct` (int8 conv, folded
     BN or GN, activation, output fake-quant); bare ``Conv2d`` with in/out
     >= 128 outside a conv+norm module and not named cls/reg/pred/obj ->
     :class:`QBareConv`; ResNet ``Bottleneck``/``BasicBlock`` outputs ->
     :class:`FakeQuantOut`.

   A module whose scales are missing stays in float, as in the JAX package
   (its ``test_missing_scales_noop``): that is the reference's semantics,
   not a device fallback.

The quantized modules compute in NHWC (the JAX package's layout) and take
and return NCHW views, so they slot into the float models unchanged.
Numerics follow the JAX package's, operation for operation: weights are
quantized per output channel from the float32 parameters, the int8
convolution accumulates exactly in int32 (``ops/int8_conv.py``), the
requant is ``clip(round(x / s), -127, 127)`` in float32, and the int8
GroupNorm uses eps 1e-6 where the float models use 1e-5.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from glsdet_tpu_torch.models.build import resolve_device
from glsdet_tpu_torch.models.gfl_head import GFLHead
from glsdet_tpu_torch.models.layers import ConvNormAct
from glsdet_tpu_torch.models.mp_head import MPHead, proxy_scores
from glsdet_tpu_torch.models.resnet import (BasicBlock, Bottleneck, ResNet,
                                            ResNetConv)
from glsdet_tpu_torch.ops.gn_kernel import gn_relu_quant_acc
from glsdet_tpu_torch.ops.int8_conv import (Int8Conv2d, Int8Module,
                                            fake_quant, place_quantized,
                                            quantize_weight, requant)

__all__ = ["calibrate_scales", "quantize_static", "save_scales",
           "load_scales"]

SCALES_FORMAT = "glsdet-int8-scales-v1"
# bare Conv2d joins the int8 path only at >= 128 in AND out channels: the
# prediction convs stay full precision by construction
BARE_CONV_MIN_CHANNELS = 128
INT8_GN_EPS = 1e-6         # quant_static.py:316, :489 (float models: 1e-5)
HEAD_GN_GROUPS = 32        # ConvNormAct's default

REWRITE_KINDS = (ResNetConv, ConvNormAct)
BOUNDARY_KINDS = (Bottleneck, BasicBlock)


def save_scales(path: str, scales) -> str:
    """Write calibrated scales as JSON: one ``{module_path: scale}`` dict
    (one model) or a ``(coarse, mp)`` pair (the two-stage pipeline)."""
    if isinstance(scales, dict):
        payload = {"format": SCALES_FORMAT, "scales": scales}
    else:
        coarse, mp = scales
        payload = {"format": SCALES_FORMAT, "coarse": dict(coarse),
                   "mp": dict(mp)}
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    return path


def load_scales(path: str):
    """Inverse of :func:`save_scales`: the dict or the ``(coarse, mp)``
    tuple."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("format") != SCALES_FORMAT:
        raise ValueError(f"{path}: not a {SCALES_FORMAT} file")
    if "scales" in payload:
        return payload["scales"]
    return payload["coarse"], payload["mp"]


# --------------------------------------------------------------------------
# eligibility (quant_static.py:122-161)
# --------------------------------------------------------------------------

def _eligible(m: nn.Module, min_channels: int) -> bool:
    conv = m.conv
    return (conv.groups == 1 and conv.in_channels >= min_channels
            and conv.out_channels >= min_channels)


def _bare_conv_eligible(name: str, m: nn.Module,
                        parent: Optional[nn.Module]) -> bool:
    if not isinstance(m, nn.Conv2d) or isinstance(parent, REWRITE_KINDS):
        return False
    leaf = name.rsplit(".", 1)[-1]
    if any(s in leaf for s in ("cls", "reg", "pred", "obj")):
        return False
    if m.groups != 1 or tuple(m.dilation) != (1, 1) or isinstance(
            m.padding, str):
        return False
    return (m.in_channels >= BARE_CONV_MIN_CHANNELS
            and m.out_channels >= BARE_CONV_MIN_CHANNELS)


def _parents(model: nn.Module) -> Dict[str, nn.Module]:
    out = {}
    for name, m in model.named_modules():
        for child_name, _ in m.named_children():
            out[f"{name}.{child_name}" if name else child_name] = m
    return out


def _key(name: str) -> str:
    return name.replace(".", "/")


# --------------------------------------------------------------------------
# calibration (quant_static.py:213-272)
# --------------------------------------------------------------------------

@torch.inference_mode()
def calibrate_scales(model: nn.Module, batches,
                     min_channels: int = 32) -> Dict[str, float]:
    """Run ``model`` over ``batches`` (NCHW tensors on its device) and
    record, with forward hooks, each eligible module's input and output
    absmax; returns ``{path_key: max(absmax, 1e-6) / 127}``.

    ``.in``: eligible ``ResNetConv``/``ConvNormAct`` and bare convs.
    ``.out``: every ``ResNetConv``/``ConvNormAct`` and ResNet block with
    >= ``min_channels`` output channels.  The maximum runs over batches
    and over repeated calls (the head towers serve 5 levels); each batch
    costs one forward and one transfer of the recorded scalars."""
    records: Dict[str, torch.Tensor] = {}

    def record(key, t):
        mx = t.detach().abs().amax().float()
        prev = records.get(key)
        records[key] = mx if prev is None else torch.maximum(prev, mx)

    def hook(key_in, key_out):
        def fn(module, args, out):
            if key_in is not None:
                record(key_in, args[0])
            if (key_out is not None and out.dim() == 4
                    and out.shape[1] >= min_channels):
                record(key_out, out)
        return fn

    parents = _parents(model)
    handles = []
    for name, m in model.named_modules():
        key_in = key_out = None
        if type(m) in REWRITE_KINDS:
            key_out = _key(name) + ".out"
            if _eligible(m, min_channels):
                key_in = _key(name) + ".in"
        elif type(m) in BOUNDARY_KINDS:
            key_out = _key(name) + ".out"
        elif _bare_conv_eligible(name, m, parents.get(name)):
            key_in = _key(name) + ".in"
        if key_in or key_out:
            handles.append(m.register_forward_hook(hook(key_in, key_out)))
    acc: Dict[str, float] = {}
    try:
        for batch in batches:
            records.clear()
            model(batch)
            if records:
                vals = torch.stack(list(records.values())).cpu().tolist()
                for k, v in zip(records, vals):
                    acc[k] = max(acc.get(k, 0.0), v)
    finally:
        for h in handles:
            h.remove()
    return {k: max(v, 1e-6) / 127.0 for k, v in acc.items()}


# --------------------------------------------------------------------------
# per-module rewrite (quant_static.py:178-348)
# --------------------------------------------------------------------------

def _fold_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, bias: torch.Tensor,
             per_module: bool):
    """Inference BN folded into (kernel, bias), float32.  The JAX package
    associates the bias two ways: ``(bias - mean) * s + beta`` in the
    per-module rewrite (``_folded_weights``) and ``beta - mean * s`` in
    the explicit ResNet (``_int8_resnet_forward``)."""
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    w = conv.weight.float() * s[:, None, None, None]
    mean, beta = bn.running_mean.float(), bn.bias.float()
    if per_module:
        return w, (bias - mean) * s + beta
    return w, beta - mean * s


def _group_norm(y, gamma, beta, groups: int, dtype):
    """``quant_static._group_norm``: ``dtype`` storage, float32 statistics,
    eps 1e-6, the affine applied in ``dtype``.  y: (B, H, W, C) float32."""
    b, h, w, c = y.shape
    g = min(groups, c)
    yg = y.to(dtype).reshape(b, h, w, g, c // g)
    yf = yg.float()
    mean = yf.mean(dim=(1, 2, 4), keepdim=True)
    var = (yf * yf).mean(dim=(1, 2, 4), keepdim=True) - mean * mean
    scale = torch.rsqrt(var + INT8_GN_EPS) * gamma.reshape(g, c // g)
    bias = beta.reshape(g, c // g) - mean * scale
    return (yg * scale.to(dtype) + bias.to(dtype)).reshape(b, h, w, c)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class QConv(Int8Module):
    """int8 convolution with its dequantization epilogue: (B, H, W, Cin)
    int8 codes of scale ``s_x`` -> float32 ``acc * (s_x * s_w) [+ bias]``
    (``quant_static.py: _qconv`` without the activation).  ``w``: the
    float32 OIHW kernel, BatchNorm already folded in."""

    def __init__(self, w: torch.Tensor, s_x: float, bias=None, stride=1,
                 padding=0):
        super().__init__()
        q_w, s_w = quantize_weight(w)
        self.conv = Int8Conv2d(q_w, stride, padding)
        self.register_buffer("deq", s_w * float(s_x))
        self.register_buffer("bias", None if bias is None
                             else bias.float().clone())

    def forward(self, q_x: torch.Tensor) -> torch.Tensor:
        y = self.conv(q_x).float() * self.deq
        return y if self.bias is None else y + self.bias


class QConvNormAct(Int8Module):
    """``ConvNormAct``/``ResNetConv`` as int8 conv -> float32 epilogue
    (folded BN, or GN at eps 1e-6) -> activation -> fake-quant to the
    output scale (``_quant_module_call``)."""

    def __init__(self, m: nn.Module, s_in: float, s_out: Optional[float]):
        super().__init__()
        conv = m.conv
        bias = (conv.bias.float() if conv.bias is not None
                else torch.zeros(conv.out_channels,
                                 device=conv.weight.device))
        self.norm = "bn" if isinstance(m, ResNetConv) else m.norm
        if self.norm == "bn":
            w, bias = _fold_bn(conv, m.bn, bias, per_module=True)
        else:
            w = conv.weight.float()
        self.qconv = QConv(w, s_in, bias, conv.stride, conv.padding)
        if self.norm == "gn":
            self.gn_groups = m.gn.num_groups
            self.register_buffer("gn_weight", m.gn.weight.float().clone())
            self.register_buffer("gn_bias", m.gn.bias.float().clone())
        self.act = (m.act if isinstance(m, ConvNormAct)
                    else F.relu if m.act else None)
        self.s_in, self.s_out = float(s_in), s_out

    def forward(self, x):
        y = self.qconv(requant(_nhwc(x).float(), self.s_in))
        if self.norm == "gn":
            y = _group_norm(y, self.gn_weight, self.gn_bias, self.gn_groups,
                            x.dtype)
        if self.act is not None:
            y = self.act(y)
        if self.s_out is not None:
            y = fake_quant(y, self.s_out)
        return _nchw(y.to(x.dtype))


class QBareConv(Int8Module):
    """Bare ``Conv2d`` as int8 conv -> float32 dequant (+ bias), no output
    fake-quant (``_quant_bare_conv``)."""

    def __init__(self, m: nn.Conv2d, s_in: float):
        super().__init__()
        self.qconv = QConv(m.weight.float(), s_in, m.bias, m.stride,
                           m.padding)
        self.s_in = float(s_in)

    def forward(self, x):
        y = self.qconv(requant(_nhwc(x).float(), self.s_in))
        return _nchw(y.to(x.dtype))


class FakeQuantOut(nn.Module):
    """A ResNet block whose output is fake-quantized to its ``.out``
    scale (the boundary rule, ``quant_static.py:637-642``)."""

    def __init__(self, block: nn.Module, s_out: float):
        super().__init__()
        self.block = block
        self.s_out = float(s_out)

    def forward(self, x):
        return fake_quant(self.block(x), self.s_out)


# --------------------------------------------------------------------------
# explicit int8 ResNet (quant_static.py:384-458)
# --------------------------------------------------------------------------

class _Int8Bottleneck(nn.Module):
    def __init__(self, blk: Bottleneck, s_x: float, s: Dict[str, float]):
        super().__init__()

        def qconv(m, s_in):
            w, b = _fold_bn(m.conv, m.bn, None, per_module=False)
            return QConv(w, s_in, b, m.conv.stride, m.conv.padding)

        self.conv1 = qconv(blk.conv1, s_x)
        self.conv2 = qconv(blk.conv2, s["conv1.out"])
        self.conv3 = qconv(blk.conv3, s["conv2.out"])
        self.down = qconv(blk.down, s_x) if hasattr(blk, "down") else None
        self.s_x, self.s1, self.s2 = s_x, s["conv1.out"], s["conv2.out"]
        self.s_out = s["out"]

    def forward(self, q):
        y1 = requant(torch.relu(self.conv1(q)), self.s1)
        y2 = requant(torch.relu(self.conv2(y1)), self.s2)
        y3 = self.conv3(y2)                                   # float32
        idt = (self.down(q) if self.down is not None
               else q.float() * self.s_x)                     # float32
        return requant(torch.relu(y3 + idt), self.s_out)


class Int8ResNet(Int8Module):
    """Explicit int8 inference forward of a ``ResNet`` at depth >= 50:
    activations live as int8 NHWC tensors between every conv and block,
    float32 only inside the conv epilogues and the residual adds.

    - Stem: its input and its folded kernel are rounded to bfloat16 and
      convolved in float32 (the JAX package's bf16 x bf16 -> f32 conv, also
      in its float32 runs), then requantized.
    - The 3x3/2 max pool runs on the int8 codes: they are exact in
      bfloat16, so pooling there and casting back is exact (``max_pool2d``
      takes no int8 on CUDA).
    - Down-sample and residual add in float32.

    Raises ``KeyError`` when a scale is missing (the caller keeps the float
    module and rewrites its children instead)."""

    def __init__(self, m: ResNet, scales: Dict[str, float], prefix: str):
        super().__init__()

        def s_of(key):
            return float(scales[f"{prefix}/{key}" if prefix else key])

        w, b = _fold_bn(m.stem.conv, m.stem.bn, None, per_module=False)
        self.register_buffer("stem_w", w.to(torch.bfloat16).float())
        self.register_buffer("stem_b", b)
        self.s_stem = s_cur = s_of("stem.out")
        self.stages = nn.ModuleList()
        for names in m.names:
            stage = nn.ModuleList()
            for name in names:
                s = {k: s_of(f"{name}/{k}")
                     for k in ("conv1.out", "conv2.out")}
                s["out"] = s_of(f"{name}.out")
                stage.append(_Int8Bottleneck(getattr(m, name), s_cur, s))
                s_cur = s["out"]
            self.stages.append(stage)

    def forward(self, x):
        dt = x.dtype
        y = F.conv2d(x.to(torch.bfloat16).float(), self.stem_w, stride=2,
                     padding=3)
        y = torch.relu(y + self.stem_b[:, None, None])
        q = requant(_nhwc(y), self.s_stem)
        q = F.max_pool2d(_nchw(q).to(torch.bfloat16), 3, 2, 1)
        q = _nhwc(q).to(torch.int8).contiguous()
        s_cur = self.s_stem
        outs = []
        for stage in self.stages:
            for blk in stage:
                q = blk(q)
                s_cur = blk.s_out
            outs.append(_nchw((q.float() * s_cur).to(dt)))
        return tuple(outs)


# --------------------------------------------------------------------------
# explicit int8 GFL and MP heads (quant_static.py:479-599)
# --------------------------------------------------------------------------

class _Int8Tower(Int8Module):
    """One stacked GN tower: int8 codes between the convolutions; after
    each, GroupNorm (32 groups, eps 1e-6) -> ReLU -> requant, the CUDA
    kernel on the card and its plain version on the CPU.  The kernel reads
    the convolution's int32 accumulator and its ``deq`` and dequantizes on
    load, so no float tensor lies between the GEMM and the GN."""

    def __init__(self, convs, s_in0: float, s_outs):
        super().__init__()
        self.s_in0, self.s_outs = float(s_in0), [float(s) for s in s_outs]
        self.convs = nn.ModuleList()
        s_cur = self.s_in0
        for i, (m, s_out) in enumerate(zip(convs, self.s_outs)):
            self.convs.append(QConv(m.conv.weight.float(), s_cur, None,
                                    m.conv.stride, m.conv.padding))
            self.register_buffer(f"gn_weight{i}", m.gn.weight.float().clone())
            self.register_buffer(f"gn_bias{i}", m.gn.bias.float().clone())
            s_cur = s_out

    def forward(self, x):
        """x: (B, C, H, W) float view -> (B, H, W, C) in x's dtype."""
        q = requant(_nhwc(x).float(), self.s_in0)
        for i, (conv, s_out) in enumerate(zip(self.convs, self.s_outs)):
            q = gn_relu_quant_acc(conv.conv(q).contiguous(), conv.deq,
                                  getattr(self, f"gn_weight{i}"),
                                  getattr(self, f"gn_bias{i}"), s_out,
                                  groups=HEAD_GN_GROUPS, eps=INT8_GN_EPS,
                                  dtype=x.dtype)
        return (q.float() * self.s_outs[-1]).to(x.dtype)


class _Int8GNHead(Int8Module):
    """The int8 part of a GN-tower head (``GFLHead``, ``MPHead``): the cls
    and reg towers as :class:`_Int8Tower` s, the full-precision box
    predictor ``gfl_reg`` (compute dtype) and the per-level ``Scale`` s.
    ``cls_pred``: the name of the class predictor conv, also kept in full
    precision.  Raises ``KeyError`` when a scale is missing."""

    def __init__(self, m: nn.Module, scales: Dict[str, float], prefix: str,
                 cls_pred: str):
        super().__init__()

        def s_of(key):
            return float(scales[f"{prefix}/{key}" if prefix else key])

        n = m.stacked_convs
        for t in ("cls", "reg"):
            convs = [getattr(m, f"{t}_conv{i}") for i in range(n)]
            self.add_module(f"{t}_tower", _Int8Tower(
                convs, s_of(f"{t}_conv0.in"),
                [s_of(f"{t}_conv{i}.out") for i in range(n)]))
        self.cls_pred = cls_pred
        self.add_module(cls_pred, copy.deepcopy(getattr(m, cls_pred)))
        self.gfl_reg = copy.deepcopy(m.gfl_reg)
        for i in range(m.num_levels):
            self.add_module(f"scale{i}", copy.deepcopy(getattr(m, f"scale{i}")))
        self.num_classes = m.num_classes

    @staticmethod
    def _pred_conv(x, conv):
        """Full-precision 3x3 predictor conv in x's dtype, bias added after
        the convolution as in the JAX package."""
        return (F.conv2d(x, conv.weight, None, conv.stride, conv.padding)
                + conv.bias[:, None, None])

    def levels(self, feats):
        """Per level: the class predictor's NHWC output in the compute
        dtype and the float32 NHWC box distributions."""
        for lvl, x in enumerate(feats):
            cls_feat = _nchw(self.cls_tower(x))
            reg_feat = _nchw(self.reg_tower(x))
            bp = getattr(self, f"scale{lvl}")(
                self._pred_conv(reg_feat, self.gfl_reg))
            cf = self._pred_conv(cls_feat, getattr(self, self.cls_pred))
            yield _nhwc(cf), _nhwc(bp).float()


class Int8GFLHead(_Int8GNHead):
    """``GFLHead`` with int8 cls/reg towers (the non-MP branch of the JAX
    package's ``_int8_head_forward``): ``gfl_cls`` and ``gfl_reg`` stay
    full precision, the class logits in the compute dtype."""

    def __init__(self, m: GFLHead, scales: Dict[str, float], prefix: str):
        super().__init__(m, scales, prefix, "gfl_cls")

    def forward(self, feats):
        cls_out, bbox_preds = [], []
        for cf, bp in self.levels(feats):
            cls_out.append(cf)
            bbox_preds.append(bp)
        return cls_out, bbox_preds


class Int8MPHead(_Int8GNHead):
    """``MPHead`` with int8 cls/reg towers.  ``gfl_cls_conv`` and
    ``gfl_reg`` stay full precision in the compute dtype, and the proxy
    scores are computed in float32 against float32 proxies."""

    def __init__(self, m: MPHead, scales: Dict[str, float], prefix: str):
        super().__init__(m, scales, prefix, "gfl_cls_conv")
        self.register_buffer("proxies", m.proxies.detach().float().clone())
        self.register_buffer("membership", m.membership.float().clone())
        self.gamma = m.gamma

    def forward(self, feats):
        cls_out, bbox_preds = [], []
        for cf, bp in self.levels(feats):
            bbox_preds.append(bp)
            b, h, w, c = cf.shape
            sc = proxy_scores(cf.reshape(-1, c).float(), self.proxies,
                              self.membership, self.gamma)
            cls_out.append(sc.reshape(b, h, w, self.num_classes))
        return cls_out, bbox_preds


# --------------------------------------------------------------------------
# the rewrite
# --------------------------------------------------------------------------

def _quantized(name: str, m: nn.Module, parent: Optional[nn.Module],
               scales: Dict[str, float], min_channels: int
               ) -> Optional[nn.Module]:
    """The quantized replacement of ``m`` (path ``name``), or None to
    keep it and visit its children."""
    key = _key(name)
    if type(m) is ResNet and m.depth >= 50:
        try:
            return Int8ResNet(m, scales, key)
        except KeyError:
            pass
    head = {MPHead: Int8MPHead, GFLHead: Int8GFLHead}.get(type(m))
    if head is not None:
        try:
            return head(m, scales, key)
        except KeyError:
            pass
    if type(m) in REWRITE_KINDS and _eligible(m, min_channels):
        if key + ".in" in scales:
            return QConvNormAct(m, scales[key + ".in"],
                                scales.get(key + ".out"))
    elif _bare_conv_eligible(name, m, parent) and key + ".in" in scales:
        return QBareConv(m, scales[key + ".in"])
    if type(m) in BOUNDARY_KINDS and key + ".out" in scales:
        _rewrite(m, name, scales, min_channels)
        return FakeQuantOut(m, scales[key + ".out"])
    return None


def _rewrite(module: nn.Module, prefix: str, scales, min_channels) -> None:
    for child_name, child in list(module.named_children()):
        name = f"{prefix}.{child_name}" if prefix else child_name
        new = _quantized(name, child, module, scales, min_channels)
        if new is not None:
            setattr(module, child_name, new)
        else:
            _rewrite(child, name, scales, min_channels)


@torch.no_grad()
def quantize_static(model: nn.Module, scales: Dict[str, float],
                    min_channels: int = 32,
                    dtype: torch.dtype = torch.float32,
                    device="cuda") -> nn.Module:
    """A static-W8A8 copy of ``model`` (float32 weights, eval mode) on
    ``device`` (``"cuda"`` raises without a GPU), computing in ``dtype``
    outside the int8 domain.  ``scales`` comes from
    :func:`calibrate_scales` over the same model (the paths must match).
    ``model`` itself is left as it is.  Inference only: the copy's
    tensors hold no autograd history of ``model``'s (it can be deep-copied
    to another card)."""
    device = resolve_device(device)
    q = copy.deepcopy(model).float().eval()
    new = _quantized("", q, None, scales, min_channels)
    if new is None:
        _rewrite(q, "", scales, min_channels)
    return place_quantized(q if new is None else new, device, dtype)
