"""Height-trick (HT) pillar pooling (counterpart of
ocrfdet_tpu/ops/ht_pool.py).

For every BEV pillar q, the Zh height points projected into each camera
n pick the nearest feature pixel and depth bin (`_indices`: round, then
clamp), and

    out[b, q, :] = sum_n sum_z wv[b,n,z,q] * dep[b,n,pix,di] * ctx[b,n,pix,:]

with wv = valid as fp32. `ht_pool` is the wrapper of kernel K3
(`csrc/ht_pool.cu`, the counterpart of the Pallas `_ht_pool_mm`
forward): it calls the custom op `ocrfdet::ht_pool`, whose CUDA
implementation launches the kernel and whose CPU implementation is
`ht_pool_points_plain`, the per-camera gather of the JAX `ht_pool_ref`.
Both compute in fp32 from the same index streams. The registered
backward is the op `ocrfdet::ht_pool_backward` (ddep, dctx): on CUDA it
orders the valid points by row, one row per (b, camera, pixel)
(`ht_pool_order`, `ORDER_KERNEL`, inside the op; its plain version is
`ht_pool_order_plain`), then launches K3's
backward kernel (`BWD_KERNEL`), one warp a row, which writes every value
of ddep and dctx without atomics; on the CPU it is
`ht_pool_backward_plain`, the vjp of the plain version. The index
streams and wv get no gradient.
"""
from __future__ import annotations

from typing import Tuple

import torch


MAX_C = 128     # channels the kernel keeps in registers (4 per lane)
MAX_D = 2048    # depth bins the backward kernel keeps in shared memory
# points a pillar (N x Zh) whose index streams a forward block of 8
# pillars stages in the 227 KB of shared memory a block may have (3
# streams, rows of 8 + 4 words)
MAX_NZ = 227 * 1024 // (3 * 12 * 4)


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


# ------------------------------------------------ the custom ops of K3


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


ht_pool_points = ht_pool_points_plain
