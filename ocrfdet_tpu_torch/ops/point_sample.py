"""Bilinear sampling of full-resolution per-camera maps at projected
voxel points (counterpart of ocrfdet_tpu/ops/point_sample.py).

    val[bn, p, c] = sum over the 4 taps (u, v) around (px, py) of
                    relu(1-|px-u|) * relu(1-|py-v|) * map[bn, v, u, c]

in pixel coordinates (no half-pixel shift), taps outside the image
weighing zero: for px in (-1, 0) the tap u = 0 weighs 1-|px|. This is
`bilinear_sample_block` (ops/grid_sample.py), the JAX `point_sample_ref`.
`point_sample` is the wrapper of kernel K4 (`csrc/point_sample.cu`, the
counterpart of the Pallas `_point_sample_mm` forward): for CUDA tensors
it launches the kernel, for CPU tensors it runs
`point_sample_points_plain`.
Both compute in fp32. On CUDA the backward (the maps' gradient, for
every channel) launches K4's backward kernel (`BWD_KERNEL`); px and py
get none, as in the Pallas VJP. On the CPU it is the plain version's
autograd.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

KERNEL = kernels.Kernel(
    name="point_sample", source="point_sample.cu",
    symbol="point_sample_forward",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_int64]
    + [ctypes.c_void_p],
    replaces="ocrfdet_tpu/ops/point_sample.py:119")   # _point_sample_mm
BWD_KERNEL = kernels.Kernel(
    name="point_sample_bwd", source="point_sample.cu",
    symbol="point_sample_backward",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_int64]
    + [ctypes.c_void_p],
    replaces="ocrfdet_tpu/ops/point_sample.py:83")   # _bwd_kernel
MAX_C = 4


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
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    tx = px - x0
    ty = py - y0

    def axis(t0, tt, n):
        w0 = (1.0 - tt) * ((t0 >= 0) & (t0 <= n - 1)).to(tt.dtype)
        w1 = tt * ((t0 + 1 >= 0) & (t0 + 1 <= n - 1)).to(tt.dtype)
        return w0, w1

    wx0, wx1 = axis(x0, tx, W)
    wy0, wy1 = axis(y0, ty, H)
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


class _PointSampleCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, maps, px, py):
        BN, H, W, C = maps.shape
        P = px.shape[1]
        out = torch.empty((BN, P, C), dtype=torch.float32,
                          device=maps.device)
        KERNEL.launch(kernels.ptr(maps), kernels.ptr(px), kernels.ptr(py),
                      kernels.ptr(out), BN, H, W, C, P,
                      kernels.stream_of(maps))
        ctx.save_for_backward(px, py)
        ctx.map_shape = maps.shape
        return out

    @staticmethod
    def backward(ctx, grad_out):
        px, py = ctx.saved_tensors
        return (point_sample_points_backward(px, py, grad_out,
                                             ctx.map_shape), None, None)


def point_sample_points_backward(px, py, grad_out, map_shape):
    """K4's backward kernel on CUDA tensors: px/py [BN,P] and the
    cotangent dout [BN,P,C] -> dmap [BN,H,W,C] f32."""
    BN, H, W, C = map_shape
    P = px.shape[1]
    dout = grad_out.float().contiguous()
    if tuple(dout.shape) != (BN, P, C):
        raise ValueError(f"point_sample backward: dout {tuple(dout.shape)}"
                         f" != {(BN, P, C)}")
    dmap = torch.zeros((BN, H, W, C), dtype=torch.float32, device=px.device)
    BWD_KERNEL.launch(kernels.ptr(px), kernels.ptr(py), kernels.ptr(dout),
                      kernels.ptr(dmap), BN, H, W, C, P,
                      kernels.stream_of(px))
    return dmap


def point_sample_points(maps, px, py):
    """K4: maps [BN,H,W,C] f32 (C <= 4); px/py [BN,P] f32. Returns
    [BN,P,C] f32."""
    if maps.device.type == "cpu":
        return point_sample_points_plain(maps, px, py)
    if maps.device.type != "cuda":
        raise ValueError(f"point_sample: unsupported device {maps.device}")
    if maps.dim() != 4 or px.dim() != 2:
        raise ValueError("point_sample: maps [BN,H,W,C] and px/py [BN,P] "
                         "expected")
    BN, H, W, C = maps.shape
    if not 0 < C <= MAX_C:
        raise ValueError(f"point_sample: C {C} outside (0, {MAX_C}]")
    if BN > 65535:
        raise ValueError(f"point_sample: {BN} maps, at most 65535")
    for name, t in (("maps", maps), ("px", px), ("py", py)):
        if t.device != maps.device:
            raise ValueError(f"point_sample: {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"point_sample: {name} must be torch.float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"point_sample: {name} is not contiguous")
    if px.shape != py.shape or px.shape[0] != BN:
        raise ValueError(f"point_sample: px {tuple(px.shape)} / py "
                         f"{tuple(py.shape)} do not match maps "
                         f"{tuple(maps.shape)}")
    return _PointSampleCUDA.apply(maps, px, py)


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
