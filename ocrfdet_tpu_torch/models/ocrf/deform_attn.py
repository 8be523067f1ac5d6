"""Single-head deformable cross-attention of the HOA block (counterpart
of ocrfdet_tpu/models/ocrf/deform_attn.py). NCHW.

A conv offset network on the queries predicts sampling positions on a
grid downsampled by `downsample_factor`; keys and values are sampled
there bilinearly (`grid_sample`, align_corners=False, zero padding);
every full-resolution query attends over the sampled set with a SwinV2
continuous positional bias (`CPB`). The OcRF config: dim = num_height,
1 head, head dim 8, downsample 4, offset kernel 6 (depthwise, stride 4,
padding 1), offset scale 4. flax's `nn.gelu` is the tanh approximation.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.grid_sample import grid_sample_2d
from ...utils.cuda_graph import constant


class CPB(nn.Module):
    """Continuous positional bias MLP on log-signed relative coords."""

    def __init__(self, dim: int, out: int = 1):
        super().__init__()
        self.l0 = nn.Linear(2, dim)
        self.l1 = nn.Linear(dim, dim)
        self.l2 = nn.Linear(dim, out)

    def forward(self, grid_q, grid_kv):
        """grid_q [I, 2], grid_kv [B, J, 2] -> bias [B, I, J, out]."""
        pos = grid_q[None, :, None, :] - grid_kv[:, None, :, :]
        bias = torch.sign(pos) * torch.log1p(pos.abs())
        bias = F.relu(self.l0(bias))
        bias = F.relu(self.l1(bias))
        return self.l2(bias)


def _norm_grid(h: int, w: int, device) -> torch.Tensor:
    """[h, w, 2] (x, y) pixel grid."""
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([gx, gy], dim=-1)


class DeformableAttention2D(nn.Module):
    def __init__(self, dim: int, dim_head: int = 8, heads: int = 1,
                 downsample_factor: int = 4, offset_scale: float = 4.0,
                 offset_kernel_size: int = 6):
        super().__init__()
        inner = dim_head * heads
        k, ds = offset_kernel_size, downsample_factor
        self.dim_head, self.heads = dim_head, heads
        self.offset_scale = offset_scale
        self.to_q = nn.Conv2d(dim, inner, 1, bias=False)
        self.off_dw = nn.Conv2d(inner, inner, k, stride=ds,
                                padding=(k - ds) // 2, groups=inner)
        self.off_pw = nn.Conv2d(inner, 2, 1, bias=False)
        self.to_k = nn.Conv2d(dim, inner, 1, bias=False)
        self.to_v = nn.Conv2d(dim, inner, 1, bias=False)
        self.cpb = CPB(max(1, dim // 4), out=heads)
        self.to_out = nn.Conv2d(inner, dim, 1)

    def forward(self, x_q, x_kv):
        """x_q, x_kv [B, dim, H, W] -> [B, dim, H, W]."""
        B, _, H, W = x_q.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(x_q)
        off = F.gelu(self.off_dw(q), approximate="tanh")
        off = torch.tanh(self.off_pw(off)) * self.offset_scale
        hh, ww = off.shape[2:]
        vgrid = _norm_grid(hh, ww, q.device)[None] + off.permute(0, 2, 3, 1)
        norm = constant((max(ww - 1, 1), max(hh - 1, 1)), torch.float32,
                        q.device)
        vgrid_n = 2.0 * vgrid / norm - 1.0               # [B, hh, ww, 2]
        kv = grid_sample_2d(x_kv, vgrid_n, align_corners=False)
        kk, vv = self.to_k(kv), self.to_v(kv)
        qf = (q * d ** -0.5).reshape(B, h, d, H * W)
        kf = kk.reshape(B, h, d, hh * ww)
        vf = vv.reshape(B, h, d, hh * ww)
        sim = torch.einsum('bhdi,bhdj->bhij', qf, kf)
        qnorm = constant((max(W - 1, 1), max(H - 1, 1)), torch.float32,
                         q.device)
        qgrid_n = (2.0 * _norm_grid(H, W, q.device) / qnorm - 1.0) \
            .reshape(H * W, 2)
        bias = self.cpb(qgrid_n, vgrid_n.reshape(B, hh * ww, 2))
        attn = torch.softmax(sim + bias.permute(0, 3, 1, 2), dim=-1)
        out = torch.einsum('bhij,bhdj->bhdi', attn, vf)
        return self.to_out(out.reshape(B, h * d, H, W))
