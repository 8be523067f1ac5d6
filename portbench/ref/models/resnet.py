"""ResNet image backbone + CustomResNet BEV backbone (counterpart of
ocrfdet_tpu/models/resnet.py).

NCHW modules. Submodules are named after the JAX package's flax scopes
(`ConvBN_0/Conv_0`, `BatchNorm_0`, `layer1_0`, `stage0_1`, `downsample`)
so that utils/weights.py maps flax variables onto them mechanically.
BatchNorm uses eps 1e-5 and its running statistics (eval only).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F
from torch.nn import BatchNorm2d


class ConvBN(nn.Module):
    """Conv (no bias, symmetric padding dilation*(k//2)) + BN (+ relu)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, use_relu: bool = True):
        super().__init__()
        pad = dilation * (kernel // 2)
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel, stride, pad,
                                dilation=dilation, bias=False)
        self.BatchNorm_0 = BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.use_relu = use_relu

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.use_relu else x


class BasicBlock(nn.Module):
    """2-conv residual block (expansion 1)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_ch, features, 3, stride)
        self.ConvBN_1 = ConvBN(features, features, 3, 1, use_relu=False)
        self.downsample = (ConvBN(in_ch, features, 1, stride, use_relu=False)
                           if stride != 1 or in_ch != features else None)

    def forward(self, x):
        y = self.ConvBN_1(self.ConvBN_0(x))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(residual + y)


class Bottleneck(nn.Module):
    """1-3-1 residual block (expansion 4), stride on the 3x3."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_ch, features, 1, 1)
        self.ConvBN_1 = ConvBN(features, features, 3, stride)
        self.ConvBN_2 = ConvBN(features, features * 4, 1, 1, use_relu=False)
        self.downsample = (
            ConvBN(in_ch, features * 4, 1, stride, use_relu=False)
            if stride != 1 or in_ch != features * 4 else None)

    def forward(self, x):
        y = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(residual + y)


_RESNET_SPECS = {
    18: (BasicBlock, (2, 2, 2, 2), 1),
    34: (BasicBlock, (3, 4, 6, 3), 1),
    50: (Bottleneck, (3, 4, 6, 3), 4),
    101: (Bottleneck, (3, 4, 23, 3), 4),
}


class ResNet(nn.Module):
    """Image backbone returning the features of `out_indices` stages.

    Stage i has stride 4*2^i. `stem_only=True` runs the stem and stage 0
    only (the stereo reference frame's feature).
    """

    def __init__(self, depth: int = 50,
                 out_indices: Tuple[int, ...] = (0, 2, 3)):
        super().__init__()
        block_cls, layers, expansion = _RESNET_SPECS[depth]
        self.out_indices = tuple(out_indices)
        self.stem = ConvBN(3, 64, 7, 2)
        self.stage_names = []
        in_ch = 64
        for i, n_blocks in enumerate(layers):
            width = 64 * (2 ** i)
            names = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                setattr(self, f"layer{i + 1}_{j}",
                        block_cls(in_ch, width, stride))
                in_ch = width * expansion
                names.append(f"layer{i + 1}_{j}")
            self.stage_names.append(names)
        self.stage_channels = tuple(64 * (2 ** i) * expansion
                                    for i in range(len(layers)))

    def forward(self, x, stem_only: bool = False):
        x = F.max_pool2d(self.stem(x), 3, 2, 1)   # -inf padding
        outs = []
        for i, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            if stem_only and i == 0:
                return x
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


class CustomResNet(nn.Module):
    """BEV encoder backbone: BasicBlock stages with per-stage stride;
    returns the features of `backbone_output_ids` (default: all)."""

    def __init__(self, in_ch: int, num_channels: Sequence[int],
                 num_layer: Sequence[int] = (2, 2, 2),
                 stride: Sequence[int] = (2, 2, 2),
                 backbone_output_ids: Sequence[int] | None = None):
        super().__init__()
        self.out_ids = (tuple(backbone_output_ids)
                        if backbone_output_ids is not None
                        else tuple(range(len(num_channels))))
        self.stage_names = []
        for i, (ch, n, s) in enumerate(zip(num_channels, num_layer, stride)):
            names = []
            for j in range(n):
                setattr(self, f"stage{i}_{j}",
                        BasicBlock(in_ch, ch, s if j == 0 else 1))
                in_ch = ch
                names.append(f"stage{i}_{j}")
            self.stage_names.append(names)

    def forward(self, x):
        feats = []
        for i, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.out_ids:
                feats.append(x)
        return tuple(feats)
