"""Height-aware Opacity Attention (counterpart of
ocrfdet_tpu/models/ocrf/hoa.py). NCHW throughout.

  * HeightAttention: the channels split into 4 height groups, each with
    its own global max-pool -> 1x1 -> ReLU -> 1x1 bottleneck, then a
    sigmoid gate;
  * OpacityVoxelToBEV: a small U-Net (depthwise-separable conv blocks,
    max-pool 2, transposed conv 2x2/2, skip concats) with a
    HeightAttention at every scale, collapsing the 13 height slices of
    the opacity volume to one BEV opacity logit map.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn import BatchNorm2d


class HeightAttention(nn.Module):
    def __init__(self, channels: int, ratio: int = 1):
        super().__init__()
        gs = channels // 4
        mid = max(1, gs // ratio)
        self.gs = gs
        for g in range(4):
            setattr(self, f"g{g}_c1", nn.Conv2d(gs, mid, 1, bias=False))
            setattr(self, f"g{g}_c2", nn.Conv2d(mid, gs, 1, bias=False))

    def forward(self, x):
        outs = []
        for g in range(4):
            y = x[:, g * self.gs:(g + 1) * self.gs].amax(dim=(2, 3),
                                                       keepdim=True)
            y = F.relu(getattr(self, f"g{g}_c1")(y))
            outs.append(getattr(self, f"g{g}_c2")(y))
        return torch.sigmoid(torch.cat(outs, dim=1))


class _ConvBlock(nn.Module):
    """Depthwise 3x3, pointwise 1x1, BN, ReLU."""

    def __init__(self, in_ch: int, out_channels: int):
        super().__init__()
        self.dw = nn.Conv2d(in_ch, in_ch, 3, padding=1, groups=in_ch)
        self.pw = nn.Conv2d(in_ch, out_channels, 1)
        self.bn = BatchNorm2d(out_channels, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.pw(self.dw(x))))


class OpacityVoxelToBEV(nn.Module):
    """[B, Zh, H, W] opacity volume (+ a 4-channel positional encoding)
    -> [B, 1, H, W] BEV opacity logit. H and W must be multiples of 4."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.enc1 = _ConvBlock(in_ch, 4)
        self.ca1 = HeightAttention(4)
        self.enc2 = _ConvBlock(4, 8)
        self.ca2 = HeightAttention(8)
        self.bottleneck = _ConvBlock(8, 16)
        self.ca_b = HeightAttention(16)
        self.up2 = nn.ConvTranspose2d(16, 8, 2, stride=2)
        self.dec2 = _ConvBlock(16, 8)
        self.ca_d2 = HeightAttention(8)
        self.up1 = nn.ConvTranspose2d(8, 4, 2, stride=2)
        self.dec1 = _ConvBlock(8, 4)
        self.ca_d1 = HeightAttention(4)
        self.out = nn.Conv2d(4, 1, 1)

    def forward(self, x, position):
        enc1 = self.enc1(x) + position
        enc1 = self.ca1(enc1) * enc1
        enc2 = self.enc2(F.max_pool2d(enc1, 2))
        enc2 = self.ca2(enc2) * enc2
        bott = self.bottleneck(F.max_pool2d(enc2, 2))
        bott = self.ca_b(bott) * bott
        d2 = self.dec2(torch.cat([self.up2(bott), enc2], dim=1))
        d2 = self.ca_d2(d2) * d2
        d1 = self.dec1(torch.cat([self.up1(d2), enc1], dim=1))
        d1 = self.ca_d1(d1) * d1
        return self.out(d1)
