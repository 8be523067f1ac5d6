"""Camera-aware depth/semantic/context head (counterpart of
ocrfdet_tpu/models/depthnet.py).

A reduce conv, camera-parameter SE modulation (27-D MLP -> per-channel
sigmoid gates) of the context and depth towers, the stereo cost volume
brought onto the /16 grid by two stride-2 convs, three BasicBlocks +
ASPP, and a 1x1 producing D+2 depth/semantic logits; the context
channels come from a separate 1x1. NCHW throughout.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm import BatchNorm1d, BatchNorm2d
from .resnet import BasicBlock, ConvBN


class Mlp(nn.Module):
    def __init__(self, in_ch: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_ch, hidden)
        self.Dense_1 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x)))


class SELayer(nn.Module):
    """x * sigmoid(expand(relu(reduce(gate))))."""

    def __init__(self, channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels)
        self.Dense_1 = nn.Linear(channels, channels)

    def forward(self, x, gate):
        g = self.Dense_1(F.relu(self.Dense_0(gate)))
        return x * torch.sigmoid(g)[:, :, None, None]


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: dilations (1, 6, 12, 18) + a
    global pooling branch, concat -> 1x1. In train mode, dropout (flax's
    semantics: keep with probability 1 - p, scaled by 1 / (1 - p)) with
    masks drawn from `generator`."""

    def __init__(self, in_ch: int, mid_channels: int, out_channels: int,
                 dropout: float = 0.5):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_ch, mid_channels, 1)
        self.ConvBN_1 = ConvBN(in_ch, mid_channels, 3, dilation=6)
        self.ConvBN_2 = ConvBN(in_ch, mid_channels, 3, dilation=12)
        self.ConvBN_3 = ConvBN(in_ch, mid_channels, 3, dilation=18)
        self.Conv_0 = nn.Conv2d(in_ch, mid_channels, 1, bias=False)
        self.BatchNorm_0 = BatchNorm2d(mid_channels, eps=1e-5)
        self.Conv_1 = nn.Conv2d(mid_channels * 5, out_channels, 1, bias=False)
        self.BatchNorm_1 = BatchNorm2d(out_channels, eps=1e-5)
        self.dropout = dropout
        # the dropout masks' generator (train mode); None: torch's default
        self.generator = None

    def forward(self, x):
        branches = [self.ConvBN_0(x), self.ConvBN_1(x), self.ConvBN_2(x),
                    self.ConvBN_3(x)]
        gp = F.relu(self.BatchNorm_0(self.Conv_0(
            x.mean(dim=(2, 3), keepdim=True))))
        branches.append(gp.expand(-1, -1, x.shape[2], x.shape[3]))
        y = F.relu(self.BatchNorm_1(self.Conv_1(torch.cat(branches, dim=1))))
        if self.training and self.dropout > 0:
            keep = 1.0 - self.dropout
            mask = torch.rand(y.shape, generator=self.generator,
                              device=y.device) < keep
            y = torch.where(mask, y / keep, torch.zeros_like(y))
        return y


class DepthNet(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int,
                 context_channels: int, depth_channels: int,
                 stereo: bool = True, use_aspp: bool = True,
                 aspp_mid_channels: int = 96, aspp_dropout: float = 0.5,
                 cv_downsample: int = 4):
        super().__init__()
        self.stereo = stereo
        self.D = depth_channels - 2
        ratio = 16 // cv_downsample
        self.cv_ratio = ratio
        self.mlp_bn = BatchNorm1d(27, eps=1e-5)
        self.reduce_conv = ConvBN(in_channels, mid_channels, 3)
        self.context_mlp = Mlp(27, mid_channels, mid_channels)
        self.context_se = SELayer(mid_channels)
        self.context_conv = nn.Conv2d(mid_channels, context_channels, 1)
        self.depth_mlp = Mlp(27, mid_channels, mid_channels)
        self.depth_se = SELayer(mid_channels)
        depth_in = mid_channels
        if stereo:
            strides = (2 if ratio >= 2 else 1, 2 if ratio >= 4 else 1)
            for k, s in enumerate(strides):
                setattr(self, f"cv_conv{k}",
                        nn.Conv2d(self.D, self.D, 3, s, padding=1))
                setattr(self, f"cv_bn{k}", BatchNorm2d(self.D, eps=1e-5))
            depth_in += self.D
        self.depth_block0 = BasicBlock(depth_in, mid_channels, 1)
        self.depth_block1 = BasicBlock(mid_channels, mid_channels, 1)
        self.depth_block2 = BasicBlock(mid_channels, mid_channels, 1)
        self.aspp = (ASPP(mid_channels, aspp_mid_channels, mid_channels,
                          aspp_dropout) if use_aspp else None)
        self.depth_pred = nn.Conv2d(mid_channels, depth_channels, 1)

    def forward(self, x, mlp_input, cost_volume=None):
        """x [BN, C_in, H, W]; mlp_input [BN, 27]; cost_volume
        [BN, D, Hcv, Wcv] (softmaxed, stride cv_downsample) or None.
        Returns [BN, depth_ch + context_ch, H, W]."""
        mlp_input = self.mlp_bn(mlp_input)
        x = self.reduce_conv(x)
        context = self.context_se(x, self.context_mlp(mlp_input))
        context = self.context_conv(context)
        depth = self.depth_se(x, self.depth_mlp(mlp_input))
        if self.stereo:
            if cost_volume is None:
                # no previous frame: a zero volume at the cv resolution
                BN_, _, H, W = x.shape
                cost_volume = x.new_zeros(
                    (BN_, self.D, H * self.cv_ratio, W * self.cv_ratio))
            cv = self.cv_bn0(self.cv_conv0(cost_volume))
            cv = self.cv_bn1(self.cv_conv1(cv))
            depth = torch.cat([depth, cv.to(depth.dtype)], dim=1)
        depth = self.depth_block2(self.depth_block1(self.depth_block0(depth)))
        if self.aspp is not None:
            depth = self.aspp(depth)
        depth = self.depth_pred(depth)
        return torch.cat([depth, context], dim=1)
