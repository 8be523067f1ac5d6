"""Lift-Splat-Shoot view transformer (counterpart of
ocrfdet_tpu/models/view_transformer.py).

DepthNet + depth-weighted splat onto the BEV grid. The frustum is a
config constant (a buffer); projection, voxel indexing and pooling run
on the device. The splat goes through kernel K2 (ops/bev_pool.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from ..config import GridConfig, ViewTransformerConfig
from ..geometry import frustum as FR
from ..ops.bev_pool import bev_pool_lss
from .depthnet import DepthNet


def towers_autocast(device: torch.device, dtype: torch.dtype):
    """Autocast context of the conv towers (off for fp32)."""
    return torch.autocast(device_type=device.type, dtype=dtype,
                          enabled=dtype != torch.float32)


class CameraParams(NamedTuple):
    """Per-frame camera bundle (all [B, N, ...])."""
    rots: torch.Tensor        # [B,N,3,3] sensor->key-ego rotation
    trans: torch.Tensor       # [B,N,3]   sensor->key-ego translation
    intrins: torch.Tensor     # [B,N,3,3]
    post_rots: torch.Tensor   # [B,N,3,3]
    post_trans: torch.Tensor  # [B,N,3]
    bda: torch.Tensor         # [B,3,3]


class LSSViewTransformer(nn.Module):
    S = 2   # semantic (foreground/background) channels after the depth bins

    def __init__(self, grid: GridConfig, cfg: ViewTransformerConfig,
                 input_size):
        super().__init__()
        self.grid = grid
        self.cfg = cfg
        self.input_size = tuple(input_size)
        self.D = grid.num_depth_bins
        self.register_buffer("frustum", torch.from_numpy(FR.make_frustum(
            grid.depth, input_size, cfg.downsample)), persistent=False)
        self.register_buffer("cv_frustum", torch.from_numpy(FR.make_frustum(
            grid.depth, input_size, cfg.depthnet.cv_downsample)),
            persistent=False)
        dn = cfg.depthnet
        self.depth_net = DepthNet(
            in_channels=cfg.in_channels, mid_channels=cfg.in_channels,
            context_channels=cfg.out_channels,
            depth_channels=self.D + self.S, stereo=dn.stereo,
            use_aspp=dn.use_aspp, aspp_mid_channels=dn.aspp_mid_channels,
            aspp_dropout=dn.aspp_dropout, cv_downsample=dn.cv_downsample)

    def forward(self, x, mlp_input, cost_volume=None):
        """x [B,N,C,h,w]; mlp_input [B,N,27]; cost_volume
        [B*N,D,Hcv,Wcv] or None. Returns channel-last depth [B,N,h,w,D]
        (fp32 softmax), semantic [B,N,h,w,S] (fp32 softmax), context
        [B,N,h,w,C_out]."""
        B, N, C, h, w = x.shape
        out = self.depth_net(x.reshape(B * N, C, h, w),
                             mlp_input.reshape(B * N, -1), cost_volume)
        D, S = self.D, self.S
        depth = torch.softmax(out[:, :D].float(), dim=1)
        semantic = torch.softmax(out[:, D:D + S].float(), dim=1)
        context = out[:, D + S:D + S + self.cfg.out_channels]

        def last(t):
            return t.reshape(B, N, t.shape[1], h, w).permute(0, 1, 3, 4, 2)
        return last(depth), last(semantic), last(context)

    def splat(self, depth, context, cams: CameraParams):
        """depth [B,N,h,w,D], context [B,N,h,w,C] -> bev [B,Y,X,C]."""
        grid = self.grid
        coor = FR.frustum_to_ego(self.frustum, cams.rots, cams.trans,
                                 cams.intrins, cams.post_rots,
                                 cams.post_trans, cams.bda)
        X, Y = grid.bev_size
        Z = 1   # the grid collapses z (z step == full range)
        vox_idx, valid = FR.voxel_indices(
            coor, (grid.x[0], grid.y[0], grid.z[0]),
            (grid.x[2], grid.y[2], grid.z[2]), (X, Y, Z))
        return bev_pool_lss(depth.permute(0, 1, 4, 2, 3), context, vox_idx,
                            valid, (X, Y, Z))
