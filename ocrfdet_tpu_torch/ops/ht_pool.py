"""Height-trick (HT) pillar pooling (counterpart of
ocrfdet_tpu/ops/ht_pool.py).

For every BEV pillar q, the Zh height points projected into each camera
n pick the nearest feature pixel and depth bin (`_indices`: round, then
clamp), and

    out[b, q, :] = sum_n sum_z wv[b,n,z,q] * dep[b,n,pix,di] * ctx[b,n,pix,:]

with wv = valid as fp32. `ht_pool` is the wrapper of kernel K3
(`csrc/ht_pool.cu`, the counterpart of the Pallas `_ht_pool_mm`
forward): for CUDA tensors it launches the kernel, for CPU tensors it
runs `ht_pool_points_plain`, the per-camera gather of the JAX
`ht_pool_ref`. Both compute in fp32 from the same index streams. On
CUDA the backward (ddep, dctx) orders the valid points by row, one row
per (b, camera, pixel) (`ht_pool_order`, `ORDER_KERNEL`; its plain
version is `ht_pool_order_plain`), then launches K3's backward kernel
(`BWD_KERNEL`), one warp a row, which writes every value of ddep and
dctx without atomics; on the CPU the backward is the plain version's
autograd. The index streams and wv get no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

KERNEL = kernels.Kernel(
    name="ht_pool", source="ht_pool.cu", symbol="ht_pool_forward",
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    replaces="ocrfdet_tpu/ops/ht_pool.py:169")   # _ht_pool_mm
BWD_KERNEL = kernels.Kernel(
    name="ht_pool_bwd", source="ht_pool.cu", symbol="ht_pool_backward",
    argtypes=[ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    replaces="ocrfdet_tpu/ops/ht_pool.py:118")   # _bwd_kernel
ORDER_KERNEL = kernels.Kernel(     # the backward's ordering of the points
    name="ht_pool_order", source="ht_pool.cu", symbol="ht_pool_order",
    argtypes=[ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    replaces="ocrfdet_tpu/ops/ht_pool.py:118")   # _bwd_kernel
MAX_C = 128     # channels the kernel keeps in registers (4 per lane)
MAX_D = 2048    # depth bins the backward kernel keeps in shared memory


def _indices(depth_shape, uvd, valid):
    """Nearest feature pixel / depth bin per projected point. uvd
    [B,N,Zh,Nq,3] normalised; returns pix, di int32 and wv f32, each
    [B,N,Zh,Nq]. torch.round, like jnp.round, rounds half to even."""
    B, N, h, w, D = depth_shape
    ui = torch.clamp(torch.round(uvd[..., 0] * w).to(torch.int32), 0, w - 1)
    vi = torch.clamp(torch.round(uvd[..., 1] * h).to(torch.int32), 0, h - 1)
    di = torch.clamp(torch.round(uvd[..., 2] * D).to(torch.int32), 0, D - 1)
    pix = vi * w + ui
    return pix, di, valid.to(torch.float32)


def ht_pool_points_plain(dep, ctx, pix, di, wv):
    """Plain PyTorch version of kernel K3 on the index streams.

    dep [B,N,HW,D] f32; ctx [B,N,HW,C] f32; pix/di [B,N,Zh,Nq] int;
    wv [B,N,Zh,Nq] f32. Returns [B, Nq, C] f32: per camera one gather,
    summed over heights, then added over cameras in order."""
    B, N, HW, D = dep.shape
    C = ctx.shape[-1]
    Zh, Nq = pix.shape[2], pix.shape[3]
    acc = torch.zeros((B, Nq, C), dtype=torch.float32, device=ctx.device)
    for n in range(N):
        p = pix[:, n].reshape(B, Zh * Nq).long()
        dflat = p * D + di[:, n].reshape(B, Zh * Nq).long()
        wgt = torch.gather(dep[:, n].reshape(B, HW * D), 1, dflat)
        feat = torch.gather(ctx[:, n], 1, p[..., None].expand(-1, -1, C))
        wgt = wgt * wv[:, n].reshape(B, Zh * Nq)
        contrib = (feat * wgt[..., None]).reshape(B, Zh, Nq, C)
        acc = acc + contrib.sum(dim=1)
    return acc


class _HtPoolCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, dep, ctx, pix, di, wv):
        B, N, HW, D = dep.shape
        C = ctx.shape[-1]
        Zh, Nq = pix.shape[2], pix.shape[3]
        out = torch.empty((B, Nq, C), dtype=torch.float32, device=dep.device)
        KERNEL.launch(kernels.ptr(dep), kernels.ptr(ctx), kernels.ptr(pix),
                      kernels.ptr(di), kernels.ptr(wv), kernels.ptr(out),
                      B, N, HW, D, C, Zh, Nq, kernels.stream_of(dep))
        ctx_.save_for_backward(dep, ctx, pix, di, wv)
        return out

    @staticmethod
    def backward(ctx_, grad_out):
        ddep, dctx = ht_pool_points_backward(*ctx_.saved_tensors, grad_out)
        return ddep, dctx, None, None, None


def ht_pool_order_plain(pix, di, wv, HW: int, D: int):
    """Plain version of the backward's ordering, on any device: the
    valid points (wv != 0) sorted by row r = (b * N + n) * HW + pix, then
    by key = di * Zh * Nq + z * Nq + q. Returns (ends [B*N*HW] int32, the
    inclusive end of every row's range in `order`; order [n_valid] int32,
    the keys)."""
    B, N, Zh, Nq = pix.shape
    ZQ = Zh * Nq
    dev = pix.device
    valid = (wv != 0).reshape(B * N, ZQ)
    row = (torch.arange(B * N, device=dev)[:, None] * HW
           + pix.reshape(B * N, ZQ).long())
    key = (di.reshape(B * N, ZQ).long() * ZQ
           + torch.arange(ZQ, device=dev)[None, :])
    row, key = row[valid], key[valid]
    order = torch.sort(row * (D * ZQ) + key).values % (D * ZQ)
    counts = torch.zeros(B * N * HW, dtype=torch.int64, device=dev)
    counts.index_add_(0, row, torch.ones_like(row))
    return (torch.cumsum(counts, 0).to(torch.int32),
            order.to(torch.int32))


def ht_pool_order(pix, di, wv, HW: int, D: int):
    """The backward's ordering on CUDA tensors (`ORDER_KERNEL`): as
    `ht_pool_order_plain`, with `order` of length B*N*Zh*Nq of which the
    first ends[-1] entries are used. No host sync."""
    B, N, Zh, Nq = pix.shape
    R = B * N * HW
    ends = torch.empty(R, dtype=torch.int32, device=pix.device)
    counts = torch.empty_like(ends)
    placed = torch.empty(pix.numel(), dtype=torch.int32, device=pix.device)
    order = torch.empty_like(placed)
    ORDER_KERNEL.launch(kernels.ptr(pix), kernels.ptr(di), kernels.ptr(wv),
                        kernels.ptr(counts), kernels.ptr(ends),
                        kernels.ptr(placed), kernels.ptr(order), B, N, HW, D,
                        Zh, Nq, kernels.stream_of(pix))
    return ends, order


def ht_pool_backward_ordered(dep, ctx, wv, dout, ends, order, Zh: int,
                             Nq: int):
    """K3's backward kernel on CUDA tensors, given the ordering (ends,
    order) of `ht_pool_order`: (ddep [B,N,HW,D], dctx [B,N,HW,C])."""
    B, N, HW, D = dep.shape
    C = ctx.shape[-1]
    ddep = torch.empty_like(dep)
    dctx = torch.empty_like(ctx)
    BWD_KERNEL.launch(kernels.ptr(dep), kernels.ptr(ctx), kernels.ptr(wv),
                      kernels.ptr(dout), kernels.ptr(ends),
                      kernels.ptr(order), kernels.ptr(ddep),
                      kernels.ptr(dctx), B, N, HW, D, C, Zh, Nq,
                      kernels.stream_of(dep))
    return ddep, dctx


def ht_pool_points_backward(dep, ctx, pix, di, wv, grad_out):
    """K3's backward on CUDA tensors (the forward's inputs and the
    cotangent dout [B,Nq,C]): the ordering, then the kernel. Returns
    (ddep [B,N,HW,D], dctx [B,N,HW,C])."""
    B, N, HW, D = dep.shape
    C = ctx.shape[-1]
    Zh, Nq = pix.shape[2], pix.shape[3]
    dout = grad_out.float().contiguous()
    if tuple(dout.shape) != (B, Nq, C):
        raise ValueError(f"ht_pool backward: dout {tuple(dout.shape)} != "
                         f"{(B, Nq, C)}")
    ends, order = ht_pool_order(pix, di, wv, HW, D)
    return ht_pool_backward_ordered(dep, ctx, wv, dout, ends, order, Zh, Nq)


def ht_pool_points(dep, ctx, pix, di, wv):
    """K3 on the index streams (shapes as `ht_pool_points_plain`;
    pix/di int32). Returns [B, Nq, C] f32."""
    if dep.device.type == "cpu":
        return ht_pool_points_plain(dep, ctx, pix, di, wv)
    if dep.device.type != "cuda":
        raise ValueError(f"ht_pool: unsupported device {dep.device}")
    if dep.dim() != 4 or ctx.dim() != 4 or pix.dim() != 4:
        raise ValueError("ht_pool: dep/ctx [B,N,HW,*] and pix/di/wv "
                         "[B,N,Zh,Nq] expected")
    B, N, HW, D = dep.shape
    C = ctx.shape[-1]
    if tuple(ctx.shape[:3]) != (B, N, HW):
        raise ValueError(f"ht_pool: ctx {tuple(ctx.shape)} does not match "
                         f"dep {tuple(dep.shape)}")
    if not 0 < C <= MAX_C:
        raise ValueError(f"ht_pool: C {C} outside (0, {MAX_C}]")
    if not 0 < D <= MAX_D or D * pix.shape[2] * pix.shape[3] >= 2 ** 31 \
            or pix.numel() >= 2 ** 31:
        raise ValueError(f"ht_pool: D {D} outside (0, {MAX_D}], or D x Zh "
                         f"x Nq or the points past 2^31")
    for name, t, dtype in (("dep", dep, torch.float32),
                           ("ctx", ctx, torch.float32),
                           ("pix", pix, torch.int32),
                           ("di", di, torch.int32),
                           ("wv", wv, torch.float32)):
        if t.device != dep.device:
            raise ValueError(f"ht_pool: {name} on {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"ht_pool: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ht_pool: {name} is not contiguous")
        if name in ("di", "wv") and t.shape != pix.shape:
            raise ValueError(f"ht_pool: {name} {tuple(t.shape)} != pix "
                             f"{tuple(pix.shape)}")
    if tuple(pix.shape[:2]) != (B, N):
        raise ValueError(f"ht_pool: pix {tuple(pix.shape)} does not match "
                         f"dep {tuple(dep.shape)}")
    return _HtPoolCUDA.apply(dep, ctx, pix, di, wv)


def ht_pool_inputs(depth, context, uvd, valid):
    """K3's flat inputs from the module-level tensors: depth
    [B,N,h,w,D] and context [B,N,h,w,C] as f32 [B,N,h*w,*], and the
    index streams of `_indices`."""
    B, N, h, w, D = depth.shape
    C = context.shape[-1]
    pix, di, wv = _indices(depth.shape, uvd, valid)
    return (depth.reshape(B, N, h * w, D).float().contiguous(),
            context.reshape(B, N, h * w, C).float().contiguous(),
            pix.contiguous(), di.contiguous(), wv.contiguous())


def ht_pool(depth, context, uvd, valid):
    """Pool depth-weighted context at the nearest pixel / bin of every
    projected height point, summed over heights and cameras.

    depth [B,N,h,w,D]; context [B,N,h,w,C]; uvd [B,N,Zh,Nq,3] and valid
    [B,N,Zh,Nq] from geometry.frustum.project_points. Returns [B, Nq, C]
    in context's dtype (computed in fp32)."""
    out = ht_pool_points(*ht_pool_inputs(depth, context, uvd, valid))
    return out.to(context.dtype)
