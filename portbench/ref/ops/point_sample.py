"""Bilinear sampling of full-resolution per-camera maps at projected
voxel points (counterpart of ocrfdet_tpu/ops/point_sample.py).

    val[bn, p, c] = sum over the 4 taps (u, v) around (px, py) of
                    relu(1-|px-u|) * relu(1-|py-v|) * map[bn, v, u, c]

in pixel coordinates (no half-pixel shift), taps outside the image
weighing zero: for px in (-1, 0) the tap u = 0 weighs 1-|px|. This is
`bilinear_sample_block` (ops/grid_sample.py), the JAX `point_sample_ref`.
`point_sample` is the wrapper of kernel K4 (`csrc/point_sample.cu`, the
counterpart of the Pallas `_point_sample_mm` forward): it calls the
custom op `ocrfdet::point_sample`, whose CUDA implementation launches
the kernel and whose CPU implementation is `point_sample_points_plain`.
The kernel is specialised on C (1-4); for C = 4 with 16-byte aligned
maps and output it reads each tap as one 16-byte load (the launcher
picks the form; both give the same bits). Both compute in fp32. The
registered backward (the maps' gradient, for every channel; px and py
get none, as in the Pallas VJP) is the op `ocrfdet::point_sample_backward`.
On CUDA it bins the points with a tap in the image by 16 x 16 output
tile (`point_sample_order`, `ORDER_KERNEL`, inside the op; its plain
version is `point_sample_order_plain`), then launches K4's backward kernel
(`BWD_KERNEL`), one block a tile, which writes every value of dmap once,
each texel's sum in a fixed order: its points by base tap (v-1, u-1),
(v-1, u), (v, u-1), (v, u), then by point index. On the CPU it is
`point_sample_backward_walk_plain`, which adds in that order and gives
the kernel's bits.
"""
from __future__ import annotations

import torch


MAX_C = 4
TILE = 16       # texels a side of the backward kernel's output tiles


def _tent(px, py, H: int, W: int):
    """x0 = floor(px), y0 = floor(py) and each axis' two tap weights,
    (1-t)*in0 and t*in1 (t the fractional part, in the tap's in-image
    flag, computed in float so that far-off points cannot overflow an
    integer index)."""
    def axis(t0, tt, n):
        w0 = (1.0 - tt) * ((t0 >= 0) & (t0 <= n - 1)).to(tt.dtype)
        w1 = tt * ((t0 + 1 >= 0) & (t0 + 1 <= n - 1)).to(tt.dtype)
        return w0, w1
    x0, y0 = torch.floor(px), torch.floor(py)
    return x0, y0, axis(x0, px - x0, W), axis(y0, py - y0, H)


def point_sample_points_plain(maps, px, py):
    """Plain PyTorch version of kernel K4. maps [BN,H,W,C] f32; px/py
    [BN,P] f32 pixel coordinates. Returns [BN,P,C] f32.

    Per axis the two tap weights are (1-t)*in0 and t*in1 (t the
    fractional part, in the tap's in-image flag); the four products
    add in the order (x0,y0), (x0+1,y0), (x0,y0+1), (x0+1,y0+1). The
    flags are computed in float, so far-off points cannot overflow an
    integer index."""
    BN, H, W, C = maps.shape
    P = px.shape[1]
    x0, y0, (wx0, wx1), (wy0, wy1) = _tent(px, py, H, W)
    flat = maps.reshape(BN, H * W, C)

    def tap(xs, ys):
        idx = (torch.clamp(ys, 0, H - 1) * W
               + torch.clamp(xs, 0, W - 1)).long()
        return torch.gather(flat, 1, idx[..., None].expand(BN, P, C))

    out = (wy0 * wx0)[..., None] * tap(x0, y0)
    out = out + (wy0 * wx1)[..., None] * tap(x0 + 1, y0)
    out = out + (wy1 * wx0)[..., None] * tap(x0, y0 + 1)
    out = out + (wy1 * wx1)[..., None] * tap(x0 + 1, y0 + 1)
    return out


# ------------------------------------------------ the custom ops of K4


def point_sample(maps, px, py):
    """Same contract as the JAX `point_sample_ref`: maps [B,N,H,W,C],
    px/py [B,N,P] in pixel coordinates; returns [B,N,P,C] f32."""
    B, N, H, W, C = maps.shape
    P = px.shape[-1]
    out = point_sample_points(
        maps.reshape(B * N, H, W, C).float().contiguous(),
        px.reshape(B * N, P).float().contiguous(),
        py.reshape(B * N, P).float().contiguous())
    return out.reshape(B, N, P, C)


point_sample_points = point_sample_points_plain
