"""Depth-weighted frustum-to-BEV pooling, the LSS splat (counterpart of
ocrfdet_tpu/ops/bev_pool.py and ops/bev_pool_pallas.py).

    out[b, cell, :] = sum over points p with cell_p == cell of
                      w[b, p] * feat[b, pix_p, :]

`bev_pool_points` is the wrapper of kernel K2 (`csrc/bev_pool.cu`, the
counterpart of the Pallas `bev_pool_points` and of the reference's CUDA
bev_pool_v2): for CUDA tensors it sorts the points into cell intervals
(`cell_intervals`, PyTorch bookkeeping as bev_pool_v2's prepare step)
and launches the forward kernel, which pools each interval without
atomics, and its backward (dfeat and dw) launches the backward kernel
(`BWD_KERNEL`); for CPU tensors it runs `bev_pool_points_plain` (gather
+ `index_add_`), whose autograd is the backward's plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels

KERNEL = kernels.Kernel(
    name="bev_pool", source="bev_pool.cu", symbol="bev_pool_forward",
    argtypes=[ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int64]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="ocrfdet_tpu/ops/bev_pool_pallas.py:95")   # bev_pool_points
BWD_KERNEL = kernels.Kernel(
    name="bev_pool_bwd", source="bev_pool.cu", symbol="bev_pool_backward",
    argtypes=[ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int64]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    replaces="ocrfdet_tpu/ops/bev_pool_pallas.py:61")   # _bwd_kernel


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


def cell_intervals(cell_id, cells: int):
    """The forward kernel's index preparation: (perm [B*P] int64, offsets
    [B*(cells+1)+1] int32).

    perm stable-sorts the flat points b*P + p by the key b*(cells+1) +
    cell (a cell id outside [0, cells) counts as `cells`, so invalid
    points come last in each sample, and points of one cell keep their
    order); the points of key k sit at perm[offsets[k]:offsets[k+1]].
    """
    B, P = cell_id.shape
    dev = cell_id.device
    inside = (cell_id >= 0) & (cell_id < cells)
    first = torch.arange(B, dtype=torch.int32, device=dev) * (cells + 1)
    key = torch.where(inside, cell_id, cells).to(torch.int32) + first[:, None]
    keys, perm = torch.sort(key.reshape(-1), stable=True)
    offsets = torch.searchsorted(
        keys, torch.arange(B * (cells + 1) + 1, dtype=torch.int32,
                           device=dev), out_int32=True)
    return perm, offsets


@functools.lru_cache(maxsize=None)
def _chunk() -> int:
    """Sorted points per warp of the forward kernel (its source's kChunk),
    which sizes the kernel's scratch."""
    return KERNEL.function("bev_pool_forward_chunk", [])()


def bev_pool_forward(w, pix_id, cell_id, feat, cells: int, perm, offsets):
    """K2's forward kernel on CUDA tensors, given the points' intervals
    (perm, offsets) = `cell_intervals(cell_id, cells)`: [B, cells, C]
    f32."""
    B, P = w.shape
    npix, C = feat.shape[1:]
    chunks = -(-B * P // _chunk())
    out = torch.empty((B, cells, C), dtype=torch.float32, device=feat.device)
    part = torch.empty((chunks, 2, C), dtype=torch.float32,
                       device=feat.device)
    KERNEL.launch(kernels.ptr(w), kernels.ptr(pix_id), kernels.ptr(cell_id),
                  kernels.ptr(perm), kernels.ptr(offsets), kernels.ptr(feat),
                  kernels.ptr(out), kernels.ptr(part), chunks, B, P, npix, C,
                  cells, kernels.stream_of(feat))
    return out


class _BevPoolPointsCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, pix_id, cell_id, feat, cells):
        out = bev_pool_forward(w, pix_id, cell_id, feat, cells,
                               *cell_intervals(cell_id, cells))
        ctx.save_for_backward(w, pix_id, cell_id, feat)
        ctx.cells = cells
        return out

    @staticmethod
    def backward(ctx, grad_out):
        w, pix_id, cell_id, feat = ctx.saved_tensors
        dw, dfeat = bev_pool_points_backward(w, pix_id, cell_id, feat,
                                             grad_out, ctx.cells)
        return dw, None, None, dfeat, None


def bev_pool_points_backward(w, pix_id, cell_id, feat, grad_out,
                             cells: int):
    """K2's backward kernel on CUDA tensors (the forward's inputs and
    the cotangent g [B,cells,C]): (dw [B,P], dfeat [B,npix,C]) f32."""
    B, P = w.shape
    npix, C = feat.shape[1:]
    g = grad_out.float().contiguous()
    if tuple(g.shape) != (B, cells, C):
        raise ValueError(f"bev_pool backward: g {tuple(g.shape)} != "
                         f"{(B, cells, C)}")
    dfeat = torch.zeros_like(feat)
    dw = torch.empty_like(w)
    BWD_KERNEL.launch(kernels.ptr(w), kernels.ptr(pix_id),
                      kernels.ptr(cell_id), kernels.ptr(feat), kernels.ptr(g),
                      kernels.ptr(dfeat), kernels.ptr(dw), B, P, npix, C,
                      cells, kernels.stream_of(feat))
    return dw, dfeat


def bev_pool_points(w, pix_id, cell_id, feat, cells: int):
    """K2: w [B,P] f32; pix_id/cell_id [B,P] int32 (invalid cell id =
    `cells`); feat [B,npix,C] f32. Returns [B, cells, C] f32."""
    if w.device.type == "cpu":
        return bev_pool_points_plain(w, pix_id, cell_id, feat, cells)
    if w.device.type != "cuda":
        raise ValueError(f"bev_pool_points: unsupported device {w.device}")
    B, P = w.shape
    if B * P >= 2 ** 31 or B * (cells + 1) >= 2 ** 31:
        raise ValueError(f"bev_pool_points: {B} x {P} points or {cells} "
                         f"cells exceed the kernel's int32 offsets")
    if feat.dim() != 3 or feat.shape[0] != B:
        raise ValueError(f"bev_pool_points: feat {tuple(feat.shape)} "
                         f"does not match w {tuple(w.shape)}")
    for name, t, dtype in (("w", w, torch.float32),
                           ("pix_id", pix_id, torch.int32),
                           ("cell_id", cell_id, torch.int32),
                           ("feat", feat, torch.float32)):
        if t.device != w.device:
            raise ValueError(f"bev_pool_points: {name} on {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"bev_pool_points: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"bev_pool_points: {name} is not contiguous")
        if name in ("pix_id", "cell_id") and tuple(t.shape) != (B, P):
            raise ValueError(f"bev_pool_points: {name} {tuple(t.shape)} "
                             f"!= {(B, P)}")
    return _BevPoolPointsCUDA.apply(w, pix_id, cell_id, feat, cells)


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


def bev_pool_lss(depth, feat, vox_idx, valid, bev_size):
    """Pool depth-weighted image features onto the BEV grid.

    depth [B,N,D,fH,fW]; feat [B,N,fH,fW,C]; vox_idx [B,N,D,fH,fW,3]
    int (x,y,z); valid [B,N,D,fH,fW] bool; bev_size (X,Y,Z). Returns
    [B, Y, X, Z*C] in feat's dtype, with z collapsed into channels.
    """
    X, Y, Z = bev_size
    B, C = depth.shape[0], feat.shape[-1]
    out = bev_pool_points(*lss_points(depth, feat, vox_idx, valid, bev_size))
    out = out.to(feat.dtype).reshape(B, Z, Y, X, C)
    return out.permute(0, 2, 3, 1, 4).reshape(B, Y, X, Z * C)
