"""Tiled Gaussian renderer (counterpart of
ocrfdet_tpu/ops/splat/render_tiled.py).

  1. `_compact`: where there are more than `global_cap` Gaussians, keep
     the nearest `global_cap` valid ones, depth-ascending;
  2. `_select_packed`: a coarse pass picks the nearest `coarse_cap`
     Gaussians overlapping each 2x2 block of tiles, a fine pass the
     nearest M per tile from its block's candidates, and the attributes
     of every tile's M Gaussians are gathered front to back into one
     tensor [B, T, M, 11] (dead slots have op == 0);
  3. kernel K5 (composite.py) composites every tile.

Selection is PyTorch. The JAX package orders every stage with
`jax.lax.top_k`, which puts the lower index first among equal values;
the synthetic rig has exact depth ties (every voxel of one plane seen
square-on has the same camera depth), and their order changes the
composite where such Gaussians overlap. `torch.topk` promises no order
among ties on CUDA, so every stage here is a stable descending
`torch.sort`, which keeps the lower index first, as top_k does.
Everything is batched over the samples (leading dim B).
"""
from __future__ import annotations

import numpy as np
import torch

from . import composite
from .preprocess import Gaussians2D


def _top_k(x, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    in index order (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x, idx):
    """x [B, G, *f] gathered along G by idx [B, *i] -> [B, *i, *f]."""
    B, G, feat = x.shape[0], x.shape[1], x.shape[2:]
    rows = x.reshape(B, G, -1)
    g = torch.gather(rows, 1, idx.reshape(B, -1, 1).expand(
        -1, -1, rows.shape[-1]))
    return g.reshape(*idx.shape, *feat)


def _compact(g: Gaussians2D, color, opacity, global_cap: int):
    """Keep the nearest `global_cap` valid Gaussians, depth-ascending."""
    neg_inf = torch.full_like(g.depth, -float("inf"))
    gprio = torch.where(g.valid & (g.radius > 0), -g.depth, neg_inf)
    gp, gidx = _top_k(gprio, global_cap)
    keep_valid = torch.isfinite(gp)
    radius = torch.where(keep_valid, torch.gather(g.radius, 1, gidx),
                         torch.zeros_like(gp))
    g = Gaussians2D(mean2d=_take(g.mean2d, gidx), conic=_take(g.conic, gidx),
                    radius=radius, depth=torch.gather(g.depth, 1, gidx),
                    valid=torch.gather(g.valid, 1, gidx) & keep_valid)
    return g, _take(color, gidx), torch.gather(opacity, 1, gidx)


def _raster_perm(n_tx: int, n_ty: int) -> np.ndarray:
    """Raster tile t -> its slot in the (coarse block, sibling) layout."""
    n_ctx = -(-n_tx // 2)
    perm = np.zeros((n_ty * n_tx,), np.int64)
    for ty in range(n_ty):
        for tx in range(n_tx):
            perm[ty * n_tx + tx] = ((ty // 2) * n_ctx + tx // 2) * 4 \
                + (ty % 2) * 2 + tx % 2
    return perm


def _select_packed(g: Gaussians2D, color, opacity, n_tx: int, n_ty: int,
                   tile_h: int, tile_w: int, M: int, coarse_cap: int,
                   coarse_group: int = 16):
    """Two-level per-tile selection. Returns (attrs [B, T, M, 11] in
    raster tile order with depth ascending along M, dead slots op == 0;
    gidx [B, T, M], the Gaussian of every slot; overflow [B])."""
    B, G = color.shape[:2]
    dev = color.device
    r = g.radius
    mx, my = g.mean2d[..., 0], g.mean2d[..., 1]
    x0 = torch.floor((mx - r) / tile_w)
    x1 = torch.floor((mx + r) / tile_w)
    y0 = torch.floor((my - r) / tile_h)
    y1 = torch.floor((my + r) / tile_h)
    g_ok = g.valid & (r > 0)
    neg_inf = -float("inf")
    neg_depth = torch.where(g_ok, -g.depth, torch.full_like(g.depth, neg_inf))
    all_attr = torch.stack(
        [mx, my, g.conic[..., 0], g.conic[..., 1], g.conic[..., 2],
         g.radius, g.depth, (opacity * g_ok.to(opacity.dtype)).float(),
         color[..., 0], color[..., 1], color[..., 2]], -1).float()
    bbox_all = torch.stack([x0, x1, y0, y1], -1)            # [B, G, 4]

    n_ctx, n_cty = -(-n_tx // 2), -(-n_ty // 2)
    Tc = n_ctx * n_cty
    Mc = min(coarse_cap, G)
    # coarse tiles padded to a multiple of `coarse_group` with copies of
    # block (0, 0), as the JAX package's grouped map (they count in its
    # coarse overflow and are never used)
    Tcp = Tc + (-Tc) % coarse_group
    cti = torch.arange(Tcp, device=dev)
    ctix = torch.where(cti < Tc, cti % n_ctx, 0).float()
    ctiy = torch.where(cti < Tc, cti // n_ctx, 0).float()

    cx, cy = ctix[None, :, None], ctiy[None, :, None]       # [1, Tcp, 1]
    ov = ((2 * cx <= x1[:, None]) & (2 * cx + 1 >= x0[:, None])
          & (2 * cy <= y1[:, None]) & (2 * cy + 1 >= y0[:, None])
          & g_ok[:, None])                                  # [B, Tcp, G]
    c_ovf = torch.clamp(ov.sum(-1) - Mc, min=0).sum(-1)
    prio = torch.where(ov, neg_depth[:, None], torch.full_like(
        ov, neg_inf, dtype=neg_depth.dtype))
    del ov
    cprio, cidx = _top_k(prio, Mc)                          # [B, Tcp, Mc]
    del prio
    bbox = _take(bbox_all, cidx)                            # [B,Tcp,Mc,4]
    bx0, bx1, by0, by1 = bbox.unbind(-1)

    # fine stage: each coarse block owns its 2x2 fine siblings
    sx = torch.tensor([0.0, 1.0, 0.0, 1.0], device=dev)
    sy = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    ftix = 2 * ctix[:, None] + sx                           # [Tcp, 4]
    ftiy = 2 * ctiy[:, None] + sy
    fx, fy = ftix[None, :, :, None], ftiy[None, :, :, None]
    ov_f = ((fx >= bx0[:, :, None]) & (fx <= bx1[:, :, None])
            & (fy >= by0[:, :, None]) & (fy <= by1[:, :, None]))
    prio_f = torch.where(ov_f, cprio[:, :, None],
                         torch.full_like(cprio[:, :, None], neg_inf))
    real_f = ((ftix < n_tx) & (ftiy < n_ty) & (cti < Tc)[:, None])
    live_c = torch.isfinite(cprio)[:, :, None]
    f_ovf = torch.where(real_f, torch.clamp(
        (ov_f & live_c).sum(-1) - M, min=0), 0).sum((-1, -2))
    fprio, fidx = _top_k(prio_f, M)                         # [B,Tcp,4,M]
    flive = torch.isfinite(fprio)

    gidx = torch.gather(cidx[:, :, None].expand(-1, -1, 4, -1), 3, fidx)
    perm = torch.from_numpy(_raster_perm(n_tx, n_ty)).to(dev)
    gidx = gidx.reshape(B, Tcp * 4, M)[:, perm]             # [B, T, M]
    live = flive.reshape(B, Tcp * 4, M)[:, perm]
    attrs = _take(all_attr, gidx)                           # [B, T, M, 11]
    op = attrs[..., 7] * live.to(attrs.dtype)
    attrs = torch.cat([attrs[..., :7], op[..., None], attrs[..., 8:]], -1)
    return attrs, gidx, c_ovf + f_ovf


def render_gaussians_tiled(g: Gaussians2D, color, opacity, height: int,
                           width: int, tile_h: int = 16, tile_w: int = 16,
                           max_per_tile: int = 512, global_cap: int = 65536,
                           coarse_cap: int = 2048,
                           bg_color=(0.0, 0.0, 0.0)):
    """Render every sample: g fields [B, G, ...], color [B, G, 3],
    opacity [B, G]. Returns (image [B, H, W, 3], median depth [B, H, W],
    overflow [B] int): one K5 launch for all the samples' tiles."""
    assert height % tile_h == 0 and width % tile_w == 0
    n_ty, n_tx = height // tile_h, width // tile_w
    T = n_ty * n_tx
    B, G = color.shape[:2]
    if G > global_cap:
        g, color, opacity = _compact(g, color, opacity, global_cap)
        G = global_cap
    M = min(max_per_tile, G)
    attrs, _, overflow = _select_packed(
        g, color, opacity, n_tx, n_ty, tile_h, tile_w, M,
        coarse_cap=max(coarse_cap, M))
    rgb, med, logt = composite.composite_tiles(
        attrs.reshape(B * T, M, len(composite.STREAMS)).contiguous(), T,
        n_tx, tile_h, tile_w)
    bg = torch.tensor(bg_color, dtype=torch.float32, device=rgb.device)
    img = rgb + torch.exp(logt)[..., None] * bg
    img = img.reshape(B, n_ty, n_tx, tile_h, tile_w, 3) \
        .permute(0, 1, 3, 2, 4, 5).reshape(B, height, width, 3)
    med = med.reshape(B, n_ty, n_tx, tile_h, tile_w) \
        .permute(0, 1, 3, 2, 4).reshape(B, height, width)
    return img, med, overflow
