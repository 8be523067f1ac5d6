"""BEV fusion, attention and mask modules of the OcRF branch
(counterpart of ocrfdet_tpu/models/ocrf/fusion.py). NCHW throughout.

MS_CAM (local + global channel attention), DualFeatFusion (a channel
gate between the LSS and HT features), ChannelAttention /
SpatialAttention / ResCBAMBlock, ProbNet (the BEV foreground mask
logit), BEVGeomAttention and OpacityMask (spatial gates), and
LearnedPositionalEncoding (row/col embedding tables). BatchNorm: eps
1e-5, running statistics in eval.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn import BatchNorm2d


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5)


class MS_CAM(nn.Module):
    def __init__(self, in_ch: int, out_channels: int, r: int = 4):
        super().__init__()
        inter = max(1, in_ch // r)
        for name in ("local", "global"):
            setattr(self, f"{name}_c1", nn.Conv2d(in_ch, inter, 1))
            setattr(self, f"{name}_bn1", _bn(inter))
            setattr(self, f"{name}_c2", nn.Conv2d(inter, out_channels, 1))
            setattr(self, f"{name}_bn2", _bn(out_channels))

    def _branch(self, y, name):
        def layer(n):
            return getattr(self, f"{name}_{n}")
        y = F.relu(layer("bn1")(layer("c1")(y)))
        return layer("bn2")(layer("c2")(y))

    def forward(self, x):
        xl = self._branch(x, "local")
        xg = self._branch(x.mean(dim=(2, 3), keepdim=True), "global")
        return torch.sigmoid(xl + xg)


class DualFeatFusion(nn.Module):
    """g * x1 + (1 - g) * x2 with g = MS_CAM(x1 || x2)."""

    def __init__(self, channels: int):
        super().__init__()
        self.ca = MS_CAM(2 * channels, channels)

    def forward(self, x1, x2):
        g = self.ca(torch.cat([x1, x2], dim=1))
        return g * x1 + (1.0 - g) * x2


class ChannelAttention(nn.Module):
    def __init__(self, channels: int, out_channels: int, ratio: int = 16):
        super().__init__()
        mid = max(1, channels // ratio)
        self.fc1 = nn.Conv2d(channels, mid, 1, bias=False)
        self.fc2 = nn.Conv2d(mid, out_channels, 1, bias=False)

    def forward(self, x):
        def fc(y):
            return self.fc2(F.relu(self.fc1(y)))
        return torch.sigmoid(fc(x.mean(dim=(2, 3), keepdim=True))
                             + fc(x.amax(dim=(2, 3), keepdim=True)))


def _avg_max(x):
    """Channel mean || channel max -> [B,2,H,W]."""
    return torch.cat([x.mean(dim=1, keepdim=True),
                      x.amax(dim=1, keepdim=True)], dim=1)


class SpatialAttention(nn.Module):
    def __init__(self, kernel: int = 7):
        super().__init__()
        self.Conv_0 = nn.Conv2d(2, 1, kernel, padding=kernel // 2,
                                bias=False)

    def forward(self, x):
        return torch.sigmoid(self.Conv_0(_avg_max(x)))


class ResCBAMBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = _bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = _bn(channels)
        self.ca = ChannelAttention(channels, channels)
        self.sa = SpatialAttention()

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        y = self.ca(y) * y
        y = self.sa(y) * y
        return F.relu(x + y)


class ProbNet(nn.Module):
    """BEV foreground-probability head: [B,C,H,W] -> logit [B,1,H,W]."""

    def __init__(self, in_channels: int):
        super().__init__()
        mid = in_channels // 2
        self.base_conv = nn.Conv2d(in_channels, mid, 3, padding=1)
        self.base_bn = _bn(mid)
        self.prob_conv = ResCBAMBlock(mid)
        self.mask_net = nn.Conv2d(mid, 1, 1)

    def forward(self, x):
        y = F.relu(self.base_bn(self.base_conv(x)))
        return self.mask_net(self.prob_conv(y))


class BEVGeomAttention(nn.Module):
    """sigmoid(conv(avg || max) + logit): a spatial gate [B,1,H,W]."""

    def __init__(self, kernel: int = 7):
        super().__init__()
        self.Conv_0 = nn.Conv2d(2, 1, kernel, padding=kernel // 2,
                                bias=False)

    def forward(self, x, logit):
        return torch.sigmoid(self.Conv_0(_avg_max(x)) + logit)


class OpacityMask(BEVGeomAttention):
    """The same gate conditioned on the HOA opacity logit."""


class LearnedPositionalEncoding(nn.Module):
    """mmdet LearnedPositionalEncoding: [B, 2*num_feats, h, w], the
    column embedding in the first num_feats channels, the row embedding
    in the rest."""

    def __init__(self, num_feats: int, h: int, w: int):
        super().__init__()
        self.row_embed = nn.Parameter(torch.zeros(h, num_feats))
        self.col_embed = nn.Parameter(torch.zeros(w, num_feats))

    def forward(self, batch: int):
        h, nf = self.row_embed.shape
        w = self.col_embed.shape[0]
        pos = torch.cat([self.col_embed.t()[:, None, :].expand(nf, h, w),
                         self.row_embed.t()[:, :, None].expand(nf, h, w)])
        return pos[None].expand(batch, 2 * nf, h, w)
