"""Conv+BN folding for inference, the counterpart of
``glsdet_tpu.models.fuse`` (mmdet's ``--fuse-conv-bn``).

Every module with a ``conv`` and a ``bn`` child (``ConvNormAct``,
``ResNetConv``; depthwise convolutions included) is folded in place:

    s       = bn.weight / sqrt(running_var + eps)
    weight' = weight * s              (per output channel)
    bn'     = identity normalization with bias (bias - mean * s):
              weight 1, mean 0, var 1 - eps

The BN module stays (as in the JAX package, whose parameter structure is
fixed at init) and reduces to a bias add.  ``eps`` is the JAX package's
``BN_EPS`` for every pair, as there.  :func:`fold_conv_bn` is the
arithmetic, shared with ``ops/fused_infer.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from glsdet_tpu_torch.models.layers import BN_EPS


@torch.no_grad()
def fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, eps: float = BN_EPS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(folded OIHW weight, folded bias), both float32."""
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + eps)
    weight = conv.weight.float() * s[:, None, None, None]
    return weight, bn.bias.float() - bn.running_mean.float() * s


@torch.no_grad()
def fuse_conv_bn(model: nn.Module, eps: float = BN_EPS
                 ) -> Tuple[nn.Module, int]:
    """Fold every conv+bn pair of ``model`` in place; returns (model,
    number of pairs folded).  Inference outputs are unchanged up to float
    association; do not train from a folded model."""
    n = 0
    for m in model.modules():
        conv, bn = getattr(m, "conv", None), getattr(m, "bn", None)
        if not (isinstance(conv, nn.Conv2d)
                and isinstance(bn, nn.BatchNorm2d)):
            continue
        weight, bias = fold_conv_bn(conv, bn, eps)
        conv.weight.copy_(weight)
        bn.weight.fill_(1.0)
        bn.bias.copy_(bias)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - eps)
        n += 1
    return model, n
