"""VGGT Aggregator, the frozen geometry teacher of GeoEnhDet
(counterpart of ocrfdet_tpu/models/vggt.py).

The reference's VGGT Aggregator (vggt/models/aggregator.py): a DINOv2
ViT patch embedder with register tokens (or, in miniature tests, one
conv), camera and register tokens (one embedding for the first frame,
another for the rest), 2D rotary position embedding on the patch tokens,
and `depth` pairs of frame-attention (the tokens of each frame) and
global-attention (the tokens of every frame) blocks with QK-norm and
layer scale. It returns the [frame | global] 2*dim token stream of the
last layer.

Module and parameter names follow the JAX package's flax scopes
(`frame_block{i}.attn.qkv`, `patch_embed.block{i}.mlp_fc1`, `ls1`, ...)
so that the weight bridge carries its variables over;
`convert_torch_state_dict` maps the released VGGT checkpoint's layout
onto them. The attention is F.scaled_dot_product_attention (softmax in
fp32 inside it), which is not one of the repository's kernels.
LayerNorm eps: 1e-5 in the VGGT blocks and their QK-norm, 1e-6 in the
DINOv2 blocks and its final norm. GELU is the exact erf form.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def rope_2d_freqs(dim: int, positions: torch.Tensor, base: float = 100.0):
    """2D RoPE angles of the reference RotaryPositionEmbedding2D: the head
    dim splits into a vertical half rotated by y and a horizontal half
    rotated by x, and each half rotates pairs (i, i + dim/4) within
    itself. positions [T, 2] (y, x) -> (cos, sin) [T, dim], laid out as
    quarter blocks [aV, aV, aH, aH]."""
    quarter = dim // 4
    freqs = 1.0 / (base ** (torch.arange(quarter, dtype=torch.float32,
                                         device=positions.device)
                            / quarter))
    ay = positions[:, 0:1] * freqs[None]
    ax = positions[:, 1:2] * freqs[None]
    ang = torch.cat([ay, ay, ax, ax], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., T, d]: rotate-half within each d/2 half (pairs (i,
    i + d/4))."""
    d = x.shape[-1]
    h, q = d // 2, d // 4

    def rot_half(t):
        return torch.cat([-t[..., q:], t[..., :q]], dim=-1)

    v, hh = x[..., :h], x[..., h:]
    out_v = v * cos[..., :h] + rot_half(v) * sin[..., :h]
    out_h = hh * cos[..., h:] + rot_half(hh) * sin[..., h:]
    return torch.cat([out_v, out_h], dim=-1)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qk_norm: bool = True,
                 eps: float = 1e-5):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        if qk_norm:
            self.q_norm = nn.LayerNorm(hd, eps=eps)
            self.k_norm = nn.LayerNorm(hd, eps=eps)
        self.qk_norm = qk_norm
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, rope=None):
        """x [B, T, dim]; rope = (cos, sin) [T, hd] or None."""
        B, T, dim = x.shape
        q, k, v = self.qkv(x).reshape(B, T, 3, self.num_heads, -1) \
            .permute(2, 0, 3, 1, 4)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if rope is not None:
            q = apply_rope(q, *rope)
            k = apply_rope(k, *rope)
        q, k = q.to(v.dtype), k.to(v.dtype)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(B, T, dim))


class Block(nn.Module):
    """Pre-norm transformer block with layer scale (`ls1`, `ls2`, flax
    init `init_values`)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: float = 0.01, qk_norm: bool = True,
                 eps: float = 1e-5):
        super().__init__()
        self.ls1 = nn.Parameter(torch.full((dim,), init_values))
        self.ls2 = nn.Parameter(torch.full((dim,), init_values))
        # the weight bridge's init of the raw parameters above
        self.raw_inits = {"ls1": ("constant", init_values),
                          "ls2": ("constant", init_values)}
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, qk_norm=qk_norm, eps=eps)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        h = int(dim * mlp_ratio)
        self.mlp_fc1 = nn.Linear(dim, h)
        self.mlp_fc2 = nn.Linear(h, dim)

    def forward(self, x, rope=None):
        x = x + self.ls1 * self.attn(self.norm1(x), rope=rope)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + self.ls2 * y


def torch_bicubic_matrix(n_in: int, n_out: int,
                         scale_factor: Optional[float] = None) -> np.ndarray:
    """[n_out, n_in] matrix of torch's `F.interpolate(mode='bicubic',
    align_corners=False, antialias=False)`: the cubic convolution kernel
    a = -0.75, source coordinate (o + 0.5) / scale - 0.5 with `scale` the
    explicit scale_factor where given (DINOv2's interpolate_offset kludge
    passes (n_out + 0.1) / n_in) else n_out / n_in, taps clamped at the
    border."""
    A = -0.75

    def cubic(t):        # |t| <= 1
        return ((A + 2.0) * t - (A + 3.0)) * t * t + 1.0

    def cubic2(t):       # 1 < |t| <= 2
        return ((A * t - 5.0 * A) * t + 8.0 * A) * t - 4.0 * A

    scale = float(scale_factor) if scale_factor else n_out / n_in
    W = np.zeros((n_out, n_in), np.float64)
    for o in range(n_out):
        src = (o + 0.5) / scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        w4 = (cubic2(t + 1.0), cubic(t), cubic(1.0 - t), cubic2(2.0 - t))
        for k, wk in enumerate(w4):
            W[o, int(np.clip(i0 - 1 + k, 0, n_in - 1))] += wk
    return W.astype(np.float32)


class DinoViT(nn.Module):
    """DINOv2 ViT with register tokens, the VGGT-1B patch embedder
    (vit_large, patch 14, 4 registers, layer scale init 1.0). Returns the
    final-LayerNorm patch tokens. The position embedding is kept at its
    native grid and resized to the patch grid with torch's non-antialiased
    bicubic and DINOv2's +0.1 scale kludge (`torch_bicubic_matrix`)."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 num_register_tokens: int = 4, native_grid: int = 37):
        super().__init__()
        D, ng = embed_dim, native_grid
        self.patch_size, self.depth, self.native_grid = \
            patch_size, depth, native_grid
        self.num_register_tokens = num_register_tokens
        self.proj = nn.Conv2d(3, D, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.register_tokens = nn.Parameter(
            torch.zeros(1, num_register_tokens, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + ng * ng, D))
        self.raw_inits = {"cls_token": ("normal", 1e-6),
                          "register_tokens": ("normal", 1e-6),
                          "pos_embed": ("normal", 0.02)}
        for i in range(depth):
            setattr(self, f"block{i}", Block(D, num_heads, init_values=1.0,
                                             qk_norm=False, eps=1e-6))
        self.norm = nn.LayerNorm(D, eps=1e-6)

    def forward(self, images):
        """images [B, H, W, 3] -> patch tokens [B, ph*pw, dim]."""
        B, H, W, _ = images.shape
        p, ng = self.patch_size, self.native_grid
        ph, pw = H // p, W // p
        x = self.proj(images.permute(0, 3, 1, 2))
        D = x.shape[1]
        x = x.flatten(2).transpose(1, 2)
        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (ph, pw) != (ng, ng):
            def mat(n):
                return torch.from_numpy(torch_bicubic_matrix(
                    ng, n, scale_factor=(n + 0.1) / ng)).to(x.device)
            pp = pos_patch.reshape(ng, ng, D).float()
            pp = torch.einsum("ri,cj,ijd->rcd", mat(ph), mat(pw), pp)
            pos_patch = pp.reshape(1, ph * pw, D)
        # cat(cls, patches) + pos, then the registers after cls without a
        # position embedding
        x = torch.cat([self.cls_token.expand(B, 1, D).to(x.dtype), x], 1)
        x = x + torch.cat([pos_cls, pos_patch], 1).to(x.dtype)
        x = torch.cat([x[:, :1], self.register_tokens.expand(
            B, -1, D).to(x.dtype), x[:, 1:]], 1)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.norm(x)
        return x[:, 1 + self.num_register_tokens:]


_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)


class Aggregator(nn.Module):
    def __init__(self, patch_size: int = 14, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 num_register_tokens: int = 4, rope_base: float = 100.0,
                 patch_embed: str = "dinov2", vit_depth: int = 24,
                 vit_native_grid: int = 37):
        """`patch_embed`: "dinov2" (the VGGT-1B layout) or "conv" (one
        conv, miniature tests)."""
        super().__init__()
        D = embed_dim
        self.patch_size, self.embed_dim, self.depth = patch_size, D, depth
        self.num_heads, self.rope_base = num_heads, rope_base
        self.num_register_tokens = num_register_tokens
        if patch_embed == "dinov2":
            self.patch_embed = DinoViT(patch_size, D, vit_depth, num_heads,
                                       num_register_tokens, vit_native_grid)
        else:
            self.patch_embed = nn.Conv2d(3, D, patch_size, stride=patch_size)
        self.camera_token = nn.Parameter(torch.zeros(2, 1, D))
        self.register_token = nn.Parameter(
            torch.zeros(2, num_register_tokens, D))
        self.raw_inits = {"camera_token": ("normal", 1e-6),
                          "register_token": ("normal", 1e-6)}
        for i in range(depth):
            setattr(self, f"frame_block{i}", Block(D, num_heads))
            setattr(self, f"global_block{i}", Block(D, num_heads))

    def forward(self, images) -> Tuple[torch.Tensor, int]:
        """images [B, S, H, W, 3] -> (tokens [B, S, T, 2*dim] of the last
        layer, the index of the first patch token).

        The input is normalised with the ResNet mean/std, as the reference
        does, also where it is already ImageNet-normalised (GeoEnhDet's
        teacher input): the double normalisation is the reference's."""
        B, S, H, W, _ = images.shape
        p, D = self.patch_size, self.embed_dim
        ph, pw = H // p, W // p
        mean = images.new_tensor(_RESNET_MEAN)
        std = images.new_tensor(_RESNET_STD)
        flat = ((images - mean) / std).reshape(B * S, H, W, 3)
        if isinstance(self.patch_embed, DinoViT):
            x = self.patch_embed(flat)
        else:
            x = self.patch_embed(flat.permute(0, 3, 1, 2)).flatten(2) \
                .transpose(1, 2)
        # the first frame takes embedding 0, every other frame embedding 1
        sel = torch.tensor([0] + [1] * (S - 1), device=x.device)
        R = self.num_register_tokens
        cam = self.camera_token[sel][None].expand(B, S, 1, D)
        reg = self.register_token[sel][None].expand(B, S, R, D)
        x = x.reshape(B, S, ph * pw, D)
        x = torch.cat([cam.to(x.dtype), reg.to(x.dtype), x], dim=2)
        T = x.shape[2]
        patch_start = 1 + R

        # the patches' positions start at 1; the special tokens sit at 0
        ys = torch.arange(ph, dtype=torch.float32,
                          device=x.device).repeat_interleave(pw) + 1.0
        xs = torch.arange(pw, dtype=torch.float32, device=x.device) \
            .repeat(ph) + 1.0
        pos = torch.cat([torch.zeros(patch_start, 2, device=x.device),
                         torch.stack([ys, xs], -1)], 0)
        rope = rope_2d_freqs(D // self.num_heads, pos, self.rope_base)
        # the global blocks repeat each frame's positions
        rope_g = tuple(t.repeat(S, 1) for t in rope)

        frame_out = global_out = x
        for i in range(self.depth):
            xf = getattr(self, f"frame_block{i}")(
                x.reshape(B * S, T, D), rope=rope)
            frame_out = xf.reshape(B, S, T, D)
            xg = getattr(self, f"global_block{i}")(
                frame_out.reshape(B, S * T, D), rope=rope_g)
            global_out = xg.reshape(B, S, T, D)
            x = global_out
        return torch.cat([frame_out, global_out], dim=-1), patch_start


def convert_torch_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The released VGGT aggregator's state dict (keys without the
    `aggregator.` prefix; tensors or numpy arrays) as the port's
    `Aggregator` state dict. Both patch embedders: one conv
    (`patch_embed.proj.*`) or a DINOv2 ViT (`patch_embed.patch_embed.
    proj.*`, `patch_embed.blocks.{i}.*`, `patch_embed.{cls_token,
    pos_embed,register_tokens,norm.*}`; its `mask_token` is not used).
    The layouts are torch's on both sides, so this only renames, and
    drops the leading batch axis of the camera and register tokens."""
    src = {k: torch.as_tensor(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}

    def block(dst, p, qk_norm):
        names = ["norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
                 "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
                 "attn.proj.bias"]
        if qk_norm:
            names += [f"attn.{n}_norm.{w}" for n in "qk"
                      for w in ("weight", "bias")]
        for n in names:
            out[f"{dst}.{n}"] = src[f"{p}.{n}"]
        for ls in ("ls1", "ls2"):
            out[f"{dst}.{ls}"] = src[f"{p}.{ls}.gamma"]
        for fc in ("fc1", "fc2"):
            for w in ("weight", "bias"):
                out[f"{dst}.mlp_{fc}.{w}"] = src[f"{p}.mlp.{fc}.{w}"]

    out["camera_token"] = src["camera_token"][0]
    out["register_token"] = src["register_token"][0]
    if "patch_embed.proj.weight" in src:            # the conv embedder
        for w in ("weight", "bias"):
            out[f"patch_embed.{w}"] = src[f"patch_embed.proj.{w}"]
    else:                                           # the DINOv2 ViT
        pe = "patch_embed"
        for n in ("cls_token", "pos_embed", "register_tokens",
                  "norm.weight", "norm.bias"):
            out[f"{pe}.{n}"] = src[f"{pe}.{n}"]
        for w in ("weight", "bias"):
            out[f"{pe}.proj.{w}"] = src[f"{pe}.patch_embed.proj.{w}"]
        i = 0
        while f"{pe}.blocks.{i}.norm1.weight" in src:
            block(f"{pe}.block{i}", f"{pe}.blocks.{i}", qk_norm=False)
            i += 1
    for grp, pref in (("frame_block", "frame_blocks"),
                      ("global_block", "global_blocks")):
        i = 0
        while f"{pref}.{i}.norm1.weight" in src:
            block(f"{grp}{i}", f"{pref}.{i}", qk_norm=True)
            i += 1
    return {k: v.float().contiguous() for k, v in out.items()}


def load_torch_weights(aggregator: Aggregator, ckpt_path: str) -> Aggregator:
    """Load a released VGGT checkpoint (a full model's state dict, or one
    under "model") into `aggregator`, strictly: a key left over or
    missing on either side raises."""
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if "model" in sd and not any(k.startswith("aggregator.") for k in sd):
        sd = sd["model"]
    sd = {k[len("aggregator."):]: v for k, v in sd.items()
          if k.startswith("aggregator.")}
    aggregator.load_state_dict(convert_torch_state_dict(sd), strict=True)
    return aggregator
