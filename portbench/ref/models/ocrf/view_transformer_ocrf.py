"""OcRF view transformer (counterpart of
ocrfdet_tpu/models/ocrf/view_transformer_ocrf.py), as an eval model runs
it.

Per frame:
  1. the LSS view transformer (`lss`) gives depth, semantic and context;
     depth below depth_threshold / D is zeroed and context is masked
     where the foreground probability is below semantic_threshold;
  2. the LSS splat (kernel K2) and the height-trick pool (kernel K3) of
     the thresholded depth and context onto the BEV grid;
  3. the voxel lift of the HT feature (per-height affine, BatchNorm over
     the height axis, ReLU) and its opacity (`A_MLP`);
  4. NeRF alphas 1 - exp(-sigma) of every camera at full image
     resolution, sampled at the projected voxel points (kernel K4) and
     averaged over the cameras that see each point;
  5. HOA: deformable attention of the opacity (query) over the alphas
     (key/value) at 1/6 scale, added back to the opacity, then the
     opacity U-Net -> BEV opacity logit;
  6. dual LSS/HT fusion, ProbNet (BEV mask logit) and the two gates.

The render branch, its heads and the profiling seams (`cfg.ablate`) of
the original, which only training and profiling run, are not copied. The
conv towers run under the caller's autocast (`towers`); geometry, K2,
K3, K4 and the masked camera mean run in fp32. Module layouts are NCHW;
the BEV output is NCHW [B, C, Y, X], the aux logits keep the JAX
package's channel-last layout.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn import BatchNorm2d

from ...config import GridConfig, ViewTransformerConfig
from ...geometry import frustum as FR
from ...ops.ht_pool import ht_pool
from ...ops.point_sample import point_sample
from ..fpn import resize_bilinear
from ..view_transformer import CameraParams, LSSViewTransformer
from .deform_attn import DeformableAttention2D
from .fusion import (BEVGeomAttention, DualFeatFusion,
                     LearnedPositionalEncoding, OpacityMask, ProbNet)
from .heads import OpacityMLP, ResizeNetwork, SigmaMLP
from .hoa import OpacityVoxelToBEV


class OcRFViewTransformer(nn.Module):
    def __init__(self, grid: GridConfig, cfg: ViewTransformerConfig,
                 input_size):
        super().__init__()
        self.grid = grid
        self.cfg = cfg
        self.lss = LSSViewTransformer(grid, cfg, input_size)
        c, Zh = cfg.out_channels, cfg.num_height
        self.register_buffer("ref_points", torch.from_numpy(
            FR.ht_reference_points(cfg.bev_h, cfg.bev_w, Zh,
                                   z_pillar=grid.z[1] - grid.z[0])),
            persistent=False)
        self.fuser = DualFeatFusion(c)
        self.prob = ProbNet(c)
        self.geom_att = BEVGeomAttention()
        self.opacity_gate = OpacityMask()
        self.pos_enc = LearnedPositionalEncoding(c // 2, cfg.bev_h,
                                                 cfg.bev_w)
        self.pos_enc_hoa = LearnedPositionalEncoding(2, cfg.bev_h,
                                                     cfg.bev_w)
        # voxel lift: per-height scalar affine + BN over the height axis
        self.height_w = nn.Parameter(torch.ones(Zh))
        self.height_b = nn.Parameter(torch.zeros(Zh))
        self.height_bn = BatchNorm2d(Zh, eps=1e-5)
        self.A_MLP = OpacityMLP(c)
        self.image_feat_resize = ResizeNetwork(cfg.in_channels, c)
        self.sigma = SigmaMLP(c)
        self.defor_cross_attention = DeformableAttention2D(
            dim=Zh, dim_head=8, heads=1, downsample_factor=4,
            offset_scale=4.0, offset_kernel_size=6)
        self.OpacityVoxelToBEV = OpacityVoxelToBEV(Zh)

    @property
    def D(self) -> int:
        return self.lss.D

    def ht_pool(self, depth, context, cams: CameraParams):
        """Height-trick branch: project the Zh points of every pillar
        into all cameras and pool depth-weighted context at the nearest
        feature pixel / bin (K3). Returns (ht [B,C,Y,X] in context's
        dtype, uvd [B,N,Zh,Nq,3], valid [B,N,Zh,Nq])."""
        cfg = self.cfg
        l2i, aug = FR.ego_to_image(cams.rots, cams.trans, cams.intrins,
                                   cams.post_rots, cams.post_trans, cams.bda)
        uvd, valid = FR.project_points(
            self.ref_points, self.grid.pc_range,
            (self.grid.depth[0], self.grid.depth[1]), l2i, aug,
            self.lss.input_size)
        acc = ht_pool(depth, context, uvd, valid)           # [B, Nq, C]
        B, _, C = acc.shape
        ht = acc.transpose(1, 2).reshape(B, C, cfg.bev_h, cfg.bev_w)
        return ht, uvd, valid

    @staticmethod
    def sample_at_voxels(maps, uvd, valid):
        """Sample per-camera full-res maps [B,N,H,W,C] at the projected
        voxel points (K4) and average over the cameras that see each
        point. Returns [B, Zh, Nq, C] f32."""
        B, N, H, W, C = maps.shape
        Zh, Nq = uvd.shape[2], uvd.shape[3]
        px = (uvd[..., 0] * W).reshape(B, N, Zh * Nq)
        py = (uvd[..., 1] * H).reshape(B, N, Zh * Nq)
        vals = point_sample(maps, px, py).reshape(B, N, Zh, Nq, C)
        vmask = valid[..., None].to(vals.dtype)
        s = (vals * vmask).sum(dim=1)
        cnt = vmask.sum(dim=1)
        return s / torch.clamp(cnt, min=1.0)

    def nerf_alphas(self, x):
        """x [B,N,Cin,h,w] FPN features -> alphas [B,N,H,W] f32, where
        H, W = 16h, 16w. Cameras go through in groups so the transient
        full-resolution feature stays at most 8 images large."""
        B, N = x.shape[:2]
        group = max(1, min(N, 8 // max(B, 1)))
        parts = []
        for n0 in range(0, N, group):
            xs = x[:, n0:n0 + group]
            gN = xs.shape[1]
            full = self.image_feat_resize(xs.reshape(B * gN, *xs.shape[2:]))
            sigma = self.sigma(full)
            del full
            a = (1.0 - torch.exp(-sigma.float()))[:, 0]
            parts.append(a.reshape(B, gN, *a.shape[1:]))
        return torch.cat(parts, dim=1)

    def forward(self, x, cams: CameraParams, mlp_input, cost_volume,
                towers: Callable):
        """x [B,N,Cin,h,w] FPN features; mlp_input [B,N,27]; cost_volume
        [B*N,D,Hc,Wc] or None; towers() the autocast context of the conv
        towers. Returns (bev [B,C,Y,X], aux) with aux = depth
        [B,N,h,w,D], semantic [B,N,h,w,2], bev_mask_logit and
        opacity_bev_logit [B,Y,X,1]."""
        cfg = self.cfg
        B = x.shape[0]
        Zh, Y, X = cfg.num_height, cfg.bev_h, cfg.bev_w
        with towers():
            depth, semantic, context = self.lss(x, mlp_input, cost_volume)
        thr = cfg.depth_threshold / self.D
        f_depth = torch.where(depth < thr, torch.zeros_like(depth), depth)
        img_mask = semantic[..., 1:2] >= cfg.semantic_threshold
        f_context = context * img_mask.to(context.dtype)
        cdt = context.dtype                 # the towers' compute dtype

        lss_feat = self.lss.splat(f_depth, f_context, cams) \
            .permute(0, 3, 1, 2)                           # [B,C,Y,X]
        ht_feat, uvd, valid = self.ht_pool(f_depth, f_context, cams)

        # voxel lift [B,C,Y,X] -> [B,Zh,Nq,C] (fp32), BN over the heights
        ht_last = ht_feat.float().flatten(2).transpose(1, 2)   # [B,Nq,C]
        vf = (ht_last[:, None] * self.height_w[None, :, None, None]
              + self.height_b[None, :, None, None])
        voxel_feat = F.relu(self.height_bn(vf))
        with towers():
            opacity = self.A_MLP(voxel_feat)[..., 0]         # [B,Zh,Nq]
            alphas = self.nerf_alphas(x)                     # [B,N,H,W]
        sampled = self.sample_at_voxels(alphas[..., None], uvd, valid)
        alpha_vox = sampled[..., 0].reshape(B, Zh, Y, X)
        opac_vox = opacity.reshape(B, Zh, Y, X)

        # HOA at 1/6 scale (at least 8, so the stride-4 offset conv has
        # an output), residual add
        ds_hw = (max(Y // 6, 8), max(X // 6, 8))
        with towers():
            op_ds = resize_bilinear(opac_vox, ds_hw)
            al_ds = resize_bilinear(alpha_vox.to(op_ds.dtype), ds_hw)
            att = self.defor_cross_attention(op_ds, al_ds)
            opacity_alpha = resize_bilinear(att, (Y, X)) + opac_vox
            opacity_bev_logit = self.OpacityVoxelToBEV(
                opacity_alpha.to(cdt), self.pos_enc_hoa(B).to(cdt))

            channel_feat = self.fuser(lss_feat, ht_feat)
            bev_mask_logit = self.prob(self.pos_enc(B).to(cdt)
                                       + channel_feat)
            geom_feat = self.geom_att(channel_feat, bev_mask_logit) \
                * channel_feat
            geom_feat = geom_feat * self.opacity_gate(geom_feat,
                                                      opacity_bev_logit)
        aux: Dict[str, torch.Tensor] = dict(
            depth=depth, semantic=semantic,
            bev_mask_logit=bev_mask_logit.permute(0, 2, 3, 1),
            opacity_bev_logit=opacity_bev_logit.permute(0, 2, 3, 1))
        return geom_feat, aux
