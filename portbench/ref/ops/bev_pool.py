"""Depth-weighted frustum-to-BEV pooling, the LSS splat (counterpart of
ocrfdet_tpu/ops/bev_pool.py and ops/bev_pool_pallas.py).

    out[b, cell, :] = sum over points p with cell_p == cell of
                      w[b, p] * feat[b, pix_p, :]

`bev_pool_points` is the wrapper of kernel K2 (`csrc/bev_pool.cu`, the
counterpart of the Pallas `bev_pool_points` and of the reference's CUDA
bev_pool_v2). It calls the custom op `ocrfdet::bev_pool`. For CUDA
tensors its implementation sorts the points into cell intervals
(`cell_intervals`, PyTorch bookkeeping as bev_pool_v2's prepare step)
and launches the forward kernel, which pools each interval without
atomics; its registered backward, the op `ocrfdet::bev_pool_backward`,
launches the backward kernel (`BWD_KERNEL`), which walks each pixel's
points without atomics, over the points sorted by pixel
(`cell_intervals(pix_id, npix)`). For CPU tensors the forward is
`bev_pool_points_plain` (gather + `index_add`) and the backward the vjp
of it.

`lss_pool` is K2 on the model's path: it builds the LSS splat's streams
itself (`lss_points`) and pools them with the same op, passing their
layout, so that its backward kernel walks each pixel's D points in
closed form, since the function that made the streams knows their
layout; `lss_pool_plain` is its plain version.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch


def _flat_cell_ids(vox_idx, valid, bev_size):
    """[..., 3] voxel idx -> flat id in [0, X*Y*Z), invalid -> X*Y*Z.

    x fastest, then y, then z, as the reference's ranks.
    """
    X, Y, Z = bev_size
    ids = vox_idx[..., 2] * (Y * X) + vox_idx[..., 1] * X + vox_idx[..., 0]
    return torch.where(valid, ids, torch.full_like(ids, X * Y * Z))


def bev_pool_points_plain(w, pix_id, cell_id, feat, cells: int):
    """Plain PyTorch version of kernel K2. w [B,P] f32; pix_id/cell_id
    [B,P] int (cell id `cells` = invalid); feat [B,npix,C] f32.
    Returns [B, cells, C] f32."""
    B, P = w.shape
    C = feat.shape[-1]
    rows = torch.gather(feat, 1, pix_id.long()[..., None].expand(B, P, C))
    rows = rows * w[..., None]
    out = torch.zeros((B * (cells + 1), C), dtype=torch.float32,
                      device=feat.device)
    offs = torch.arange(B, device=feat.device)[:, None] * (cells + 1)
    out = out.index_add(0, (cell_id.long() + offs).reshape(-1),
                        rows.reshape(B * P, C))
    return out.reshape(B, cells + 1, C)[:, :cells]


# ------------------------------------------------ the custom ops of K2


def lss_points(depth, feat, vox_idx, valid, bev_size):
    """The LSS splat as K2's point streams: (w [B,P] f32, pix [B,P]
    int32, cell [B,P] int32, feat [B,npix,C] f32, cells), one point per
    (camera, depth bin, pixel) in [B,N,D,fH,fW] order."""
    X, Y, Z = bev_size
    B, N, D, fH, fW = depth.shape
    ids = _flat_cell_ids(vox_idx, valid, bev_size).to(torch.int32)
    w = torch.where(valid, depth, torch.zeros_like(depth)).float()
    pix = torch.arange(N * fH * fW, dtype=torch.int32, device=depth.device)
    pix = pix.reshape(N, 1, fH, fW).expand(B, N, D, fH, fW)
    return (w.reshape(B, -1).contiguous(), pix.reshape(B, -1).contiguous(),
            ids.reshape(B, -1).contiguous(),
            feat.reshape(B, N * fH * fW, -1).float().contiguous(), X * Y * Z)


def lss_pool_plain(depth, feat, vox_idx, valid, bev_size):
    """Plain PyTorch version of `lss_pool`."""
    return bev_pool_points_plain(*lss_points(depth, feat, vox_idx, valid,
                                             bev_size))


def bev_pool_lss(depth, feat, vox_idx, valid, bev_size):
    """Pool depth-weighted image features onto the BEV grid.

    depth [B,N,D,fH,fW]; feat [B,N,fH,fW,C]; vox_idx [B,N,D,fH,fW,3]
    int (x,y,z); valid [B,N,D,fH,fW] bool; bev_size (X,Y,Z). Returns
    [B, Y, X, Z*C] in feat's dtype, with z collapsed into channels.
    """
    X, Y, Z = bev_size
    B, C = depth.shape[0], feat.shape[-1]
    out = lss_pool(depth, feat, vox_idx, valid, bev_size)
    out = out.to(feat.dtype).reshape(B, Z, Y, X, C)
    return out.permute(0, 2, 3, 1, 4).reshape(B, Y, X, Z * C)


lss_pool = lss_pool_plain
