"""Small heads of the OcRF branch (counterpart of
ocrfdet_tpu/models/ocrf/heads.py).

`MLP2` and `OpacityMLP` run over the last axis of channel-last voxel
features; `SigmaMLP` runs per pixel over the channel axis of an NCHW map
(as 1x1 convolutions with its Linear weights, so the full-resolution
feature is never transposed); `ResizeNetwork` brings an NCHW FPN feature
to full image resolution. The render branch's heads, which only training
builds, are not copied.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class MLP2(nn.Module):
    def __init__(self, in_ch: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(in_ch, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class SigmaMLP(nn.Module):
    """NeRF density head: two stacked Linears with no activation between
    them, then softplus. x [B,C,H,W] -> [B,1,H,W]."""

    def __init__(self, in_ch: int, hidden: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(in_ch, hidden)
        self.fc2 = nn.Linear(hidden, 1)

    def forward(self, x):
        for fc in (self.fc1, self.fc2):
            x = F.conv2d(x, fc.weight[:, :, None, None], fc.bias)
        return F.softplus(x)


class OpacityMLP(nn.Module):
    """sigmoid(MLP2(x)) over the last axis -> [..., 1]."""

    def __init__(self, in_ch: int, hidden: int = 4):
        super().__init__()
        self.mlp = MLP2(in_ch, hidden, 1)

    def forward(self, x):
        return torch.sigmoid(self.mlp(x))


class ResizeNetwork(nn.Module):
    """FPN feature [B, Cin, h, w] -> [B, out_channels, 16h, 16w]: conv,
    up x2, conv, up x2, up x4 (transposed convs with kernel = stride)."""

    def __init__(self, in_ch: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 128, 3, padding=1)
        self.up1 = nn.ConvTranspose2d(128, 64, 2, stride=2)
        self.conv2 = nn.Conv2d(64, 32, 3, padding=1)
        self.up2 = nn.ConvTranspose2d(32, out_channels, 2, stride=2)
        self.up3 = nn.ConvTranspose2d(out_channels, out_channels, 4,
                                      stride=4)

    def forward(self, x):
        x = self.up1(self.conv1(x))
        return self.up3(self.up2(self.conv2(x)))
