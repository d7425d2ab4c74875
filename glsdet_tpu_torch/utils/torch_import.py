"""Reference torch checkpoints -> ``state_dict`` of the port.

A user of the reference repos holds torch ``.pth`` files in one of two
naming families:

- **yolox-drone** ``YoloBody`` (models/base/yolox.py: YOLOPAFPN backbone
  wrapping CSPDarknet + decoupled YOLOXHead) - the coarse detector;
- **mmdet-style GFL / MP-Det** (yolox-ufp: ResNet ``backbone.*``, FPN
  ``neck.*``, GFL/MP head ``bbox_head.*``) - the stage-2 detector.

The key rewrites are the JAX package's (``utils/torch_import.py``:
``_map_yolox_drone``, ``_map_mpdet``), carried over unchanged.  They
name a flax scope whose last component is the torch leaf; the port's
modules carry the flax scope names and torch's leaf names
(``utils/flax_import.py``: kernel -> ``weight``, norm scale ->
``weight``, batch stats -> ``running_mean``/``running_var``), so the
rewritten key is the port's own ``state_dict`` key.  Nothing is
transposed: the reference and the port are both OIHW.

The semantics are the JAX conversion's: every tensor is shape-checked
against the target model; ``strict`` raises on a key without a rule, a
key the model lacks and a model tensor left uncovered; ``gfl_cls`` and
``gfl_cls_conv`` name the same tensor and the model decides which;
``num_batches_tracked``, ``integral.project`` and the BoIW buffers
are skipped (``tools/import_torch_weights.py`` extracts the BoIW ones).
Like ``state_dict_from_flax`` of the JAX result, every BN's
``num_batches_tracked`` is 0 and every tensor float32.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Tuple, Union

import torch
from torch import nn

__all__ = [
    "convert_yolox_drone",
    "convert_mpdet",
    "ImportReport",
]


class ImportReport:
    """What a conversion consumed and produced."""

    def __init__(self):
        self.converted: List[Tuple[str, str]] = []  # (torch key, port key)
        self.skipped: List[str] = []                # e.g. num_batches_tracked
        self.unmatched: List[str] = []              # torch keys with no rule
        self.missing: List[str] = []                # model tensors not fed

    def summary(self) -> str:
        return (f"converted={len(self.converted)} skipped={len(self.skipped)} "
                f"unmatched={len(self.unmatched)} missing={len(self.missing)}")


MapResult = Union[None, str, Tuple[str, ...]]


# ---------------------------------------------------------------------------
# torch key -> port key (the JAX package's rewrites)
# ---------------------------------------------------------------------------

def _csp_inner(rest: str) -> str:
    """CSPLayer children: conv1/conv2/conv3/m.{i} -> repo names.

    Reference layout (yolox-drone darknet.py:66): conv1 = main branch
    1x1, conv2 = shortcut 1x1, conv3 = final merge 1x1, m = Sequential
    of Bottlenecks (conv1 1x1 + conv2 3x3; depthwise conv2 = DWConv with
    dconv/pconv children).
    """
    rest = re.sub(r"^conv1\.", "main_conv.", rest)
    rest = re.sub(r"^conv2\.", "short_conv.", rest)
    rest = re.sub(r"^conv3\.", "final_conv.", rest)
    rest = re.sub(r"^m\.(\d+)\.conv2\.dconv\.", r"block\1.conv2_dw.dw.", rest)
    rest = re.sub(r"^m\.(\d+)\.conv2\.pconv\.", r"block\1.conv2_dw.pw.", rest)
    rest = re.sub(r"^m\.(\d+)\.", r"block\1.", rest)
    return rest


def _dw(rest: str) -> str:
    """DWConv children (darknet.py DWConv: dconv/pconv) -> dw/pw."""
    rest = re.sub(r"^dconv\.", "dw.", rest)
    rest = re.sub(r"^pconv\.", "pw.", rest)
    return rest


def _map_yolox_drone(key: str) -> MapResult:
    """Rewrite one yolox-drone ``YoloBody`` torch key to a port key."""
    # --- CSPDarknet (inside YOLOPAFPN.backbone) ---
    m = re.match(r"^backbone\.backbone\.stem\.conv\.(.*)$", key)
    if m:
        return f"backbone.stem.conv.{m.group(1)}"
    m = re.match(r"^backbone\.backbone\.dark(\d)\.(\d+)\.(.*)$", key)
    if m:
        stage, idx, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        if stage == 5:
            slot = {0: "down", 1: "spp", 2: "csp"}[idx]
        else:
            slot = {0: "down", 1: "csp"}[idx]
        if slot == "down":
            return f"backbone.dark{stage}_down.{_dw(rest)}"
        if slot == "spp":
            return f"backbone.spp.{rest}"
        return f"backbone.dark{stage}_csp.{_csp_inner(rest)}"

    # --- PAFPN (YOLOPAFPN, yolox.py:95) ---
    pafpn = {
        "lateral_conv0": ("reduce5", False),
        "reduce_conv1": ("reduce4", False),
        "C3_p4": ("td_csp4", True),
        "C3_p3": ("td_csp3", True),
        "bu_conv2": ("bu_down3", False),
        "C3_n3": ("bu_csp4", True),
        "bu_conv1": ("bu_down4", False),
        "C3_n4": ("bu_csp5", True),
    }
    m = re.match(r"^backbone\.([A-Za-z0-9_]+)\.(.*)$", key)
    if m and m.group(1) in pafpn:
        name, is_csp = pafpn[m.group(1)]
        rest = _csp_inner(m.group(2)) if is_csp else _dw(m.group(2))
        return f"neck.{name}.{rest}"

    # --- decoupled head (yolox.py:11) ---
    m = re.match(r"^head\.stems\.(\d+)\.(.*)$", key)
    if m:
        return f"head.stem{m.group(1)}.{m.group(2)}"
    m = re.match(r"^head\.(cls|reg)_convs\.(\d+)\.(\d+)\.(.*)$", key)
    if m:
        branch, lvl, i, rest = m.groups()
        return f"head.{branch}{lvl}_{i}.{_dw(rest)}"
    m = re.match(r"^head\.(cls|reg|obj)_preds\.(\d+)\.(.*)$", key)
    if m:
        branch, lvl, rest = m.groups()
        return f"head.{branch}_pred{lvl}.{rest}"
    return None


def _map_mpdet(key: str) -> MapResult:
    """Rewrite one mmdet-style GFL/MP-Det torch key to a port key.

    Naming source: mmdet ResNet (``backbone.conv1/bn1/layer{s}.{i}``),
    FPN (``neck.lateral_convs/fpn_convs``, extra levels appended to
    fpn_convs per add_extra_convs='on_output'), GFL/MP head
    (``bbox_head.cls_convs.{i}.conv/gn``, ``gfl_cls``/``gfl_reg``,
    ``scales.{i}.scale``, MPHead ``proxies``).
    """
    m = re.match(r"^backbone\.conv1\.(.*)$", key)
    if m:
        return f"backbone.stem.conv.{m.group(1)}"
    m = re.match(r"^backbone\.bn1\.(.*)$", key)
    if m:
        return f"backbone.stem.bn.{m.group(1)}"
    m = re.match(r"^backbone\.layer(\d)\.(\d+)\.conv(\d)\.(.*)$", key)
    if m:
        s, i, k, rest = m.groups()
        return f"backbone.layer{s}_{i}.conv{k}.conv.{rest}"
    m = re.match(r"^backbone\.layer(\d)\.(\d+)\.bn(\d)\.(.*)$", key)
    if m:
        s, i, k, rest = m.groups()
        return f"backbone.layer{s}_{i}.conv{k}.bn.{rest}"
    m = re.match(r"^backbone\.layer(\d)\.(\d+)\.downsample\.0\.(.*)$", key)
    if m:
        s, i, rest = m.groups()
        return f"backbone.layer{s}_{i}.down.conv.{rest}"
    m = re.match(r"^backbone\.layer(\d)\.(\d+)\.downsample\.1\.(.*)$", key)
    if m:
        s, i, rest = m.groups()
        return f"backbone.layer{s}_{i}.down.bn.{rest}"
    m = re.match(r"^neck\.lateral_convs\.(\d+)\.conv\.(.*)$", key)
    if m:
        return f"neck.lateral{m.group(1)}.{m.group(2)}"
    m = re.match(r"^neck\.fpn_convs\.(\d+)\.conv\.(.*)$", key)
    if m:
        i = int(m.group(1))
        # mmdet appends the extra-level stride-2 convs to fpn_convs
        # after the per-lateral 3x3s; start_level=1 -> 3 laterals
        if i < 3:
            return f"neck.fpn_conv{i}.{m.group(2)}"
        return f"neck.extra_conv{i - 3}.{m.group(2)}"
    m = re.match(r"^bbox_head\.(cls|reg)_convs\.(\d+)\.(conv|gn)\.(.*)$", key)
    if m:
        branch, i, child, rest = m.groups()
        return f"head.{branch}_conv{i}.{child}.{rest}"
    m = re.match(r"^bbox_head\.(gfl_cls(?:_conv)?)\.(.*)$", key)
    if m:
        # GFLHead names it gfl_cls; MPHead's proxy-logit conv is
        # gfl_cls_conv (mp_head.py:68) - offer both, the model decides
        return (f"head.gfl_cls.{m.group(2)}",
                f"head.gfl_cls_conv.{m.group(2)}")
    m = re.match(r"^bbox_head\.gfl_reg\.(.*)$", key)
    if m:
        return f"head.gfl_reg.{m.group(1)}"
    m = re.match(r"^bbox_head\.scales\.(\d+)\.scale$", key)
    if m:
        return f"head.scale{m.group(1)}.scale"
    if key == "bbox_head.proxies":
        return "head.proxies"
    if re.match(r"^bbox_head\._(embedding|pos_embedding_ptr|proxies_prob)$",
                key):
        # BoIW dictionary buffers (mp_head.py:80-92) live in the port's
        # TrainState.boiw, not in the model - the CLI extracts them
        return "SKIP"
    if key == "bbox_head.integral.project":
        # the Integral layer's fixed linspace(0, reg_max) buffer
        # (gfl_head.py:31) - a constant, rebuilt by the port's decoder
        return "SKIP"
    return None


# ---------------------------------------------------------------------------
# leaves into the target model's state_dict
# ---------------------------------------------------------------------------

_COUNTER = "num_batches_tracked"


def _convert(state: Mapping[str, torch.Tensor],
             model: Union[nn.Module, Mapping[str, torch.Tensor]],
             mapper: Callable[[str], MapResult],
             strict: bool = True):
    """Shared conversion: rewrite keys, check shapes, fill the model's
    keys."""
    target = (model.state_dict() if isinstance(model, nn.Module)
              else dict(model))
    out: Dict[str, torch.Tensor] = {}
    report = ImportReport()

    for key, val in state.items():
        val = torch.as_tensor(val)
        mapped = mapper(key)
        if mapped is None:
            report.unmatched.append(key)
            if strict:
                raise KeyError(f"no rewrite rule for torch key {key!r}")
            continue
        if mapped == "SKIP":
            report.skipped.append(key)
            continue
        candidates = (mapped,) if isinstance(mapped, str) else mapped
        if candidates[0].rsplit(".", 1)[-1] == _COUNTER:
            report.skipped.append(key)
            continue
        hit = next((c for c in candidates if c in target), None)
        if hit is None:
            if strict:
                raise KeyError(f"{key} -> {candidates[0]}: not in model")
            report.unmatched.append(key)
            continue
        want = tuple(target[hit].shape)
        if tuple(val.shape) != want:
            raise ValueError(f"{key} -> {hit}: shape {tuple(val.shape)} != "
                             f"model {want}")
        out[hit] = val.detach().to("cpu", torch.float32, copy=True)
        report.converted.append((key, hit))

    for k in target:
        if k.rsplit(".", 1)[-1] == _COUNTER:
            if k.rsplit(".", 1)[0] + ".running_mean" in out:
                out[k] = torch.tensor(0)
        elif k not in out:
            report.missing.append(k)
    if strict and report.missing:
        head = ", ".join(report.missing[:8])
        more = " ..." if len(report.missing) > 8 else ""
        raise KeyError(f"model tensors not covered: {head}{more}")
    return out, report


def convert_yolox_drone(state: Mapping[str, torch.Tensor],
                        model: Union[nn.Module, Mapping[str, torch.Tensor]],
                        strict: bool = True):
    """yolox-drone ``YoloBody.state_dict()`` -> the port's YOLOX
    ``state_dict``.

    ``model`` is the target module (or its ``state_dict``); returns
    ``(state_dict, ImportReport)``, the state dict holding the converted
    tensors only.  With ``strict=False``, unmatched keys and uncovered
    model tensors are recorded in the report instead of raising (the
    reference's shape-matched partial load, yolox-drone/train.py:139-165).
    """
    return _convert(state, model, _map_yolox_drone, strict)


def convert_mpdet(state: Mapping[str, torch.Tensor],
                  model: Union[nn.Module, Mapping[str, torch.Tensor]],
                  strict: bool = True):
    """mmdet-style GFL/MP-Det state_dict -> the port's MP-Det/GFL
    ``state_dict`` (as :func:`convert_yolox_drone`)."""
    return _convert(state, model, _map_mpdet, strict)
