"""Image FPN + BEV FPN necks (counterpart of ocrfdet_tpu/models/fpn.py).

  * `CustomFPN`: single-output FPN over (C4, C5): lateral 1x1 convs,
    top-down nearest upsample + add, 3x3 output conv.
  * `FPN_LSS`: BEV neck: bilinear-up the deepest BEV feature, concat
    with the shallow one, 2x (conv3x3+BN+ReLU), then x2 upsample +
    conv3x3+BN+ReLU + conv1x1.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn import BatchNorm2d


def resize_bilinear(x, out_hw):
    """Bilinear resize of an NCHW batch, align_corners=True."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


class CustomFPN(nn.Module):
    """Only the finest level gets an output conv (the reference's
    out_ids=[0])."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i}", nn.Conv2d(c, out_channels, 1))
        self.fpn_conv0 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.n_in = len(in_channels)

    def forward(self, feats):
        laterals = [getattr(self, f"lateral{i}")(f)
                    for i, f in enumerate(feats)]
        for i in range(self.n_in - 1, 0, -1):
            # half-pixel-centre nearest, as jax.image.resize "nearest"
            up = F.interpolate(laterals[i], size=laterals[i - 1].shape[2:],
                               mode="nearest-exact")
            laterals[i - 1] = laterals[i - 1] + up
        return self.fpn_conv0(laterals[0])


class FPN_LSS(nn.Module):
    """With the reference's extra x2 upsample (extra_upsample=2)."""

    def __init__(self, in_channels: int, out_channels: int = 256):
        super().__init__()
        mid = out_channels * 2
        self.conv0 = nn.Conv2d(in_channels, mid, 3, padding=1, bias=False)
        self.bn0 = BatchNorm2d(mid, eps=1e-5)
        self.conv1 = nn.Conv2d(mid, mid, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(mid, eps=1e-5)
        self.up_conv = nn.Conv2d(mid, out_channels, 3, padding=1, bias=False)
        self.up_bn = BatchNorm2d(out_channels, eps=1e-5)
        self.out_conv = nn.Conv2d(out_channels, out_channels, 1)

    def forward(self, x_shallow, x_deep):
        def conv_bn(x, conv, bn):
            return F.relu(bn(conv(x)))
        x = torch.cat([x_shallow, resize_bilinear(x_deep,
                                                  x_shallow.shape[2:])], dim=1)
        x = conv_bn(x, self.conv0, self.bn0)
        x = conv_bn(x, self.conv1, self.bn1)
        x = resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))
        x = conv_bn(x, self.up_conv, self.up_bn)
        return self.out_conv(x)
