"""ResNet backbone (MP-Det uses ResNet-50), the counterpart of
``glsdet_tpu.models.resnet``: 7x7 stem, 4 stages, stride on the 3x3
conv of the bottleneck, BN eps 1e-3 as in the JAX package.  With
``remat`` each block is checkpointed in training (``layers.remat``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from glsdet_tpu_torch.models.layers import (BN_EPS, BN_MOMENTUM, BatchNorm2d,
                                             Conv2d, remat)

STAGE_BLOCKS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class ResNetConv(nn.Module):
    """conv (no bias) -> BN -> optional ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           kernel_size // 2, bias=False,
                           kernel_init="he_fan_out")
        self.bn = BatchNorm2d(out_channels, eps=BN_EPS,
                              momentum=BN_MOMENTUM)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = ResNetConv(in_channels, channels, 3, stride)
        self.conv2 = ResNetConv(channels, channels, 3, 1, act=False)
        if stride != 1 or in_channels != channels:
            self.down = ResNetConv(in_channels, channels, 1, stride,
                                   act=False)

    def forward(self, x):
        identity = self.down(x) if hasattr(self, "down") else x
        return F.relu(self.conv2(self.conv1(x)) + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        out = channels * 4
        self.conv1 = ResNetConv(in_channels, channels, 1, 1)
        self.conv2 = ResNetConv(channels, channels, 3, stride)
        self.conv3 = ResNetConv(channels, out, 1, 1, act=False)
        if stride != 1 or in_channels != out:
            self.down = ResNetConv(in_channels, out, 1, stride, act=False)

    def forward(self, x):
        identity = self.down(x) if hasattr(self, "down") else x
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(y + identity)


class ResNet(nn.Module):
    """ResNet-{18,34,50,101,152}; returns the stage features C2..C5."""

    def __init__(self, depth: int = 50, base_channels: int = 64,
                 remat: bool = False):
        super().__init__()
        block = Bottleneck if depth >= 50 else BasicBlock
        self.depth = depth
        self.remat = remat
        self.stem = ResNetConv(3, base_channels, 7, 2)
        self.names = []
        cin = base_channels
        self.out_channels = []
        for stage, n in enumerate(STAGE_BLOCKS[depth]):
            ch = base_channels * 2 ** stage
            names = []
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, block(cin, ch, stride))
                names.append(name)
                cin = ch * block.expansion
            self.names.append(names)
            self.out_channels.append(cin)

    def forward(self, x):
        x = self.stem(x)
        # max_pool2d pads with -inf, as flax's max_pool does
        x = F.max_pool2d(x, 3, 2, 1)
        ckpt = self.remat and self.training and torch.is_grad_enabled()
        outs = []
        for names in self.names:
            for name in names:
                block = getattr(self, name)
                x = remat(block, x) if ckpt else block(x)
            outs.append(x)
        return tuple(outs)
