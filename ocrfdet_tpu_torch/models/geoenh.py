"""GeoEnhDet: OcRFDet with VGGT geometry distillation (counterpart of
ocrfdet_tpu/models/geoenh.py; the reference's OcRFDet4DVGGT).

In train mode a frozen VGGT Aggregator teacher takes an adjacent camera
pair of the augmented key-frame images (`kd_pair`), resized to its
patch grid; the student's key-frame FPN features of the same pair are
aligned to the teacher's token space by multi-head cross-attention;
group-correlation cost volumes over the pair are built from both (in
fp32) and matched with a SmoothL1 loss (x0.1) and a cosine loss. The
teacher runs under `torch.no_grad()` in the compute dtype. An eval
forward is OcRFDet's: the teacher and the aligner do not run.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import OcRFDetConfig
from .detector import OcRFDet
from .fpn import resize_bilinear_antialiased
from .view_transformer import towers_autocast
from .vggt import Aggregator


class MultiHeadAttention(nn.Module):
    """flax's `MultiHeadDotProductAttention` (no dropout, no QK-norm):
    `query`, `key` and `value` projections to [heads, head_dim], scaled
    dot-product attention, and the `out` projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q, k, v):
        """q [B, Tq, dim], k and v [B, Tk, dim] -> [B, Tq, dim]."""
        def heads(t):
            return t.reshape(*t.shape[:2], self.num_heads, -1).transpose(1, 2)
        o = F.scaled_dot_product_attention(
            heads(self.query(q)), heads(self.key(k)), heads(self.value(v)))
        return self.out(o.transpose(1, 2).flatten(2))


class CrossAttentionAlign(nn.Module):
    """Student feature -> teacher token space (bevdet_vggt.py:16-49)."""

    def __init__(self, res_dim: int, vit_dim: int = 2048,
                 num_heads: int = 8):
        super().__init__()
        self.vit_dim = vit_dim
        self.query_proj = nn.Linear(res_dim, vit_dim)
        self.key_proj = nn.Linear(vit_dim, vit_dim)
        self.value_proj = nn.Linear(vit_dim, vit_dim)
        self.attn = MultiHeadAttention(vit_dim, num_heads)
        self.output_proj = nn.Linear(vit_dim, vit_dim)

    def forward(self, res_feat, vit_feat):
        """res_feat [BN, Hr, Wr, Cr], vit_feat [BN, Hv, Wv, Cv] ->
        [BN, Hv, Wv, vit_dim]."""
        BN, Hr, Wr, _ = res_feat.shape
        Hv, Wv = vit_feat.shape[1:3]
        q = self.query_proj(res_feat.flatten(1, 2))
        kv = vit_feat.flatten(1, 2)
        out = self.attn(q, self.key_proj(kv), self.value_proj(kv))
        out = self.output_proj(out).reshape(BN, Hr, Wr, self.vit_dim)
        return resize_bilinear_antialiased(out, (Hv, Wv))


def group_corr_cost_volume(feats, max_disp: int = 4, groups: int = 64):
    """Group-wise correlation stereo cost volume (the reference's
    build_cost_volume, 'group_corr'): feats [B, 2, H, W, C] -> cost
    [B, H, W, max_disp + 1, groups]; the right view is shifted by d along
    the width, clamped at 0."""
    B, V, H, W, C = feats.shape
    assert V == 2 and C % groups == 0
    left = feats[:, 0].reshape(B, H, W, groups, C // groups)
    right = feats[:, 1].reshape(B, H, W, groups, C // groups)
    costs = []
    for d in range(max_disp + 1):
        idx = (torch.arange(W, device=feats.device) - d).clamp(0, W - 1)
        costs.append((left * right[:, :, idx]).sum(-1))
    return torch.stack(costs, dim=3)


def smooth_l1(x, y, beta: float = 1.0):
    d = (x - y).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


class GeoEnhDet(OcRFDet):
    """OcRFDet + the KD branch. A training batch also holds `kd_pair`
    [B, 2] int32, the indices of the adjacent camera pair."""

    def __init__(self, cfg: OcRFDetConfig, render_heads: bool = False):
        super().__init__(cfg, render_heads)
        t = cfg.vggt_teacher
        self.aggregator = Aggregator(
            patch_size=t.patch_size, embed_dim=t.embed_dim, depth=t.depth,
            num_heads=t.num_heads, patch_embed=t.patch_embed,
            vit_depth=t.vit_depth, vit_native_grid=t.vit_native_grid)
        self.aligner = CrossAttentionAlign(cfg.vt.in_channels,
                                           vit_dim=2 * t.embed_dim)

    def teacher_images(self, batch) -> torch.Tensor:
        """The teacher's input [B, 2, th, tw, 3]: the `kd_pair` cameras of
        the augmented, ImageNet-normalised key-frame images, resized to
        the teacher's image size."""
        imgs = batch["imgs"][:, 0]
        B = imgs.shape[0]
        rows = torch.arange(B, device=imgs.device)[:, None]
        imgs = imgs[rows, batch["kd_pair"].long()]      # [B, 2, H, W, 3]
        th, tw = self.cfg.vggt_teacher.image_size
        return resize_bilinear_antialiased(
            imgs.flatten(0, 1), (th, tw)).reshape(B, 2, th, tw, 3)

    def kd_branch(self, fpn_key, batch) -> Dict[str, torch.Tensor]:
        """fpn_key [B, N, C, h, w], the key frame's FPN features."""
        t = self.cfg.vggt_teacher
        B = fpn_key.shape[0]
        ph, pw = (s // t.patch_size for s in t.image_size)

        def towers():
            return towers_autocast(fpn_key.device, self.dtype)
        with torch.no_grad(), towers():
            tokens, p0 = self.aggregator(
                self.teacher_images(batch).to(self.dtype))
        tok_img = tokens[:, :, p0:].reshape(B * 2, ph, pw, -1)
        rows = torch.arange(B, device=fpn_key.device)[:, None]
        feat_s = fpn_key[rows, batch["kd_pair"].long()].flatten(0, 1) \
            .permute(0, 2, 3, 1)
        with towers():
            aligned = self.aligner(feat_s, tok_img)

        groups = min(64, tokens.shape[-1])
        cv_t = group_corr_cost_volume(
            tok_img.reshape(B, 2, ph, pw, -1).float(), 4, groups)
        cv_s = group_corr_cost_volume(
            aligned.reshape(B, 2, ph, pw, -1).float(), 4, groups)
        loss_smooth = 0.1 * smooth_l1(cv_t, cv_s).mean()
        t_flat, s_flat = cv_t.reshape(B, -1), cv_s.reshape(B, -1)
        cos = (t_flat * s_flat).sum(-1) * torch.rsqrt(
            (t_flat ** 2).sum(-1) * (s_flat ** 2).sum(-1) + 1e-12)
        return dict(loss_Smoothl1_KD=loss_smooth,
                    loss_cos_KD=(1.0 - cos).mean())

    def forward(self, batch: Dict[str, torch.Tensor]):
        preds, aux = super().forward(batch)
        fpn_key = aux.pop("fpn_key")
        if self.training:
            aux.update(self.kd_branch(fpn_key, batch))
        return preds, aux
