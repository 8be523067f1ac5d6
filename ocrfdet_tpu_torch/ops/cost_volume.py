"""Stereo plane-sweep cost volume (counterpart of
ocrfdet_tpu/ops/cost_volume.py).

Warps the previous frame's stem features along D candidate depth planes
through the key->sweep sensor homography and scores |curr - warp|
summed over channels; a candidate whose warped channel C-4 is exactly 0
(out of view, behind the camera, or a post-ReLU zero) gets +bias before
the softmax over depth. The sample location is linear-fractional in
depth,

    pix(u, v, d) = (d * a2(u, v) + b2) / (d * az(u, v) + bz),

with per-pixel coefficient maps computed once (`homography_coeffs`).

`cost_volume` is the wrapper of kernel K1 (`csrc/cost_volume.cu`): it
calls the custom op `ocrfdet::cost_volume`, whose CUDA implementation
checks the inputs and launches the kernel and whose CPU implementation
is `cost_volume_plain`; its fake implementation gives the output's
shape (for `torch.export`). Both compute the EXACT bilinear warp (the TPU
kernel's window clamp is an MXU artefact that the port does not carry),
round prev to bf16 as both JAX paths do, and weight and accumulate in
fp32. The volume carries no gradient. `cost_volume_row_loads` runs the
kernel's load-counting build (`ROW_LOADS_KERNEL`, never on the model's
path) and returns how many tap rows its walks loaded.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import kernels

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])
KERNEL = kernels.Kernel(
    name="cost_volume", source="cost_volume.cu",
    symbol="cost_volume_forward", argtypes=_ARGTYPES,
    replaces="ocrfdet_tpu/ops/cost_volume.py:380")   # cost_volume_mm
ROW_LOADS_KERNEL = kernels.Kernel(
    name="cost_volume_row_loads", source="cost_volume.cu",
    symbol="cost_volume_forward", argtypes=_ARGTYPES,
    replaces=KERNEL.replaces, defines=("COST_VOLUME_COUNT_LOADS",))


def _invalid_channel(C: int) -> int:
    """Stem channel whose ==0 test flags out-of-view samples: group-
    local channel 0 of the reference's LAST 4-channel group, i.e. C-4
    (0 when C < 8)."""
    return 4 * (C // 4 - 1) if C >= 8 else 0


def homography_coeffs(cv_frustum, k2s_sensor, intrins, post_rots,
                      post_trans, input_size, feat_hw: Tuple[int, int]):
    """Per-pixel depth-linear sample-coordinate coefficients.

    The sweep-camera sample location in FEATURE-map pixels is
        x = (d*a2[...,0] + b2[...,0]) / (d*az + bz)
        y = (d*a2[...,1] + b2[...,1]) / (d*az + bz)
    and a candidate is behind the sweep camera iff d*az + bz < 1e-3.

    cv_frustum [D,Hc,Wc,3]; k2s_sensor [B,N,4,4]; intrins/post_rots
    [B,N,3,3]; post_trans [B,N,3]. Returns az [B,N,H,W], bz [B,N],
    a2 [B,N,H,W,2], b2 [B,N,2], all f32.
    """
    Hc, Wc = feat_hw
    Hi, Wi = input_size
    uv = cv_frustum[0, :, :, :2]                          # [Hc,Wc,2]
    pr2 = post_rots[..., :2, :2]
    uv_c = uv[None, None] - post_trans[:, :, None, None, :2]
    xy = torch.einsum('bnij,bnhwj->bnhwi', torch.linalg.inv(pr2), uv_c)
    q = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    rots = k2s_sensor[..., :3, :3]
    trans = k2s_sensor[..., :3, 3]
    combine = rots @ torch.linalg.inv(intrins)
    q = torch.einsum('bnij,bnhwj->bnhwi', combine, q)     # [B,N,H,W,3]
    A = torch.einsum('bnij,bnhwj->bnhwi', intrins, q)     # [B,N,H,W,3]
    Bv = torch.einsum('bnij,bnj->bni', intrins, trans)    # [B,N,3]
    a2 = (torch.einsum('bnij,bnhwj->bnhwi', pr2, A[..., :2])
          + post_trans[:, :, None, None, :2] * A[..., 2:3])
    b2 = (torch.einsum('bnij,bnj->bni', pr2, Bv[..., :2])
          + post_trans[..., :2] * Bv[..., 2:3])           # [B,N,2]
    # full-res pixel -> feature coords (align_corners scaling)
    scale = torch.tensor([(Wc - 1.0) / (Wi - 1.0), (Hc - 1.0) / (Hi - 1.0)],
                         dtype=a2.dtype, device=a2.device)
    return (A[..., 2].float(), Bv[..., 2].float(), (a2 * scale).float(),
            (b2 * scale).float())


def cost_volume_plain(curr, prev, depths, az, bz, a2, b2, bias: float):
    """Plain PyTorch version of kernel K1, one depth plane at a time.

    curr/prev [B,N,H,W,C]; depths [D]; az [B,N,H,W]; bz [B,N];
    a2 [B,N,H,W,2]; b2 [B,N,2]. Returns the raw cost [B,N,D,H,W] f32
    (bias applied, no softmax). Each coordinate operation is its own
    tensor op, one rounding each, which the kernel reproduces.
    """
    B, N, H, W, C = curr.shape
    BN, HW = B * N, H * W
    prev_f = prev.reshape(BN, HW, C).to(torch.bfloat16).float()
    curr_f = curr.reshape(BN, HW, C).float()
    az = az.reshape(BN, HW)
    a2x, a2y = a2[..., 0].reshape(BN, HW), a2[..., 1].reshape(BN, HW)
    bz = bz.reshape(BN, 1)
    b2x, b2y = b2[..., 0].reshape(BN, 1), b2[..., 1].reshape(BN, 1)
    inv_ch = _invalid_channel(C)
    D = depths.shape[0]
    out = torch.empty((BN, D, HW), dtype=torch.float32, device=curr.device)
    for d in range(D):
        dv = depths[d]
        den = dv * az + bz
        front = den >= 1e-3
        safe = torch.where(front, den, torch.ones_like(den))
        px = (dv * a2x + b2x) / safe
        py = (dv * a2y + b2y) / safe
        fx, fy = torch.floor(px), torch.floor(py)
        tx, ty = px - fx, py - fy
        wxs, wys = (1.0 - tx, tx), (1.0 - ty, ty)
        acc = torch.zeros_like(curr_f)
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = fx + dx, fy + dy
                inb = (front & (xi >= 0) & (xi <= W - 1)
                       & (yi >= 0) & (yi <= H - 1))
                w = torch.where(inb, wys[dy] * wxs[dx], torch.zeros_like(tx))
                idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
                v = torch.gather(prev_f, 1, idx[..., None].expand(BN, HW, C))
                acc = acc + w[..., None] * v
        cost = (curr_f - acc).abs().sum(-1)
        out[:, d] = torch.where(acc[..., inv_ch] == 0.0, cost + bias, cost)
    return out.reshape(B, N, D, H, W)


@torch.library.custom_op(f"{kernels.OPS_NAMESPACE}::cost_volume",
                         mutates_args=(), device_types="cpu")
def _cost_volume_op(curr: torch.Tensor, prev: torch.Tensor,
                    depths: torch.Tensor, az: torch.Tensor, bz: torch.Tensor,
                    a2: torch.Tensor, b2: torch.Tensor,
                    bias: float) -> torch.Tensor:
    return cost_volume_plain(curr, prev, depths, az, bz, a2, b2, bias)


@_cost_volume_op.register_kernel("cuda")
def _(curr, prev, depths, az, bz, a2, b2, bias):
    return _launch(KERNEL, curr, prev, depths, az, bz, a2, b2, bias)


@_cost_volume_op.register_fake
def _(curr, prev, depths, az, bz, a2, b2, bias):
    B, N, H, W, _ = curr.shape
    return curr.new_empty((B, N, depths.shape[0], H, W),
                          dtype=torch.float32)


def cost_volume(curr, prev, depths, az, bz, a2, b2, bias: float):
    """Raw plane-sweep cost [B,N,D,H,W] f32 (`ocrfdet::cost_volume`):
    kernel K1 for CUDA tensors, `cost_volume_plain` for CPU tensors."""
    return _cost_volume_op(curr, prev, depths, az, bz, a2, b2, float(bias))


def cost_volume_row_loads(curr, prev, depths, az, bz, a2, b2,
                          bias: float) -> int:
    """The tap rows K1's walks load on these CUDA inputs, counted by
    the kernel's load-counting build (same code, same results, plus a
    counter)."""
    take = ROW_LOADS_KERNEL.function("cost_volume_take_row_loads",
                                     [ctypes.c_void_p])
    rows = ctypes.c_ulonglong(0)

    def take_rows() -> int:
        code = take(ctypes.byref(rows))
        if code != 0:
            raise RuntimeError(f"cost_volume_take_row_loads: CUDA error "
                               f"{code}")
        return int(rows.value)
    torch.cuda.synchronize()
    take_rows()                  # clears the counts of earlier launches
    _launch(ROW_LOADS_KERNEL, curr, prev, depths, az, bz, a2, b2, bias)
    torch.cuda.synchronize()
    return take_rows()


def _launch(kernel, curr, prev, depths, az, bz, a2, b2, bias):
    """Check K1's inputs and launch `kernel` (a build of K1) on them."""
    B, N, H, W, C = curr.shape
    BN, D = B * N, depths.shape[0]
    if C not in (64, 256):
        raise ValueError(f"cost_volume kernel takes C 64 or 256, got {C}")
    shapes = {"prev": (prev, (B, N, H, W, C)), "az": (az, (B, N, H, W)),
              "bz": (bz, (B, N)), "a2": (a2, (B, N, H, W, 2)),
              "b2": (b2, (B, N, 2)), "depths": (depths, (D,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"cost_volume: {name} {tuple(t.shape)} != {shape}")
        if t.device != curr.device:
            raise ValueError(f"cost_volume: {name} on {t.device}, "
                             f"curr on {curr.device}")
    for name, t in (("curr", curr), ("az", az), ("bz", bz), ("a2", a2),
                    ("b2", b2), ("depths", depths)):
        if t.dtype != torch.float32:
            raise TypeError(f"cost_volume: {name} must be float32, "
                            f"got {t.dtype}")
    curr = curr.contiguous()
    prev_bf = prev.to(torch.bfloat16).contiguous()
    coef = torch.stack([az.reshape(BN, H * W), a2[..., 0].reshape(BN, H * W),
                        a2[..., 1].reshape(BN, H * W)], dim=-1).contiguous()
    cam = torch.stack([bz.reshape(BN), b2[..., 0].reshape(BN),
                       b2[..., 1].reshape(BN)], dim=-1).contiguous()
    depths = depths.contiguous()
    out = torch.empty((B, N, D, H, W), dtype=torch.float32,
                      device=curr.device)
    kernel.launch(kernels.ptr(curr), kernels.ptr(prev_bf), kernels.ptr(coef),
                  kernels.ptr(cam), kernels.ptr(depths), kernels.ptr(out),
                  BN, D, H, W, C, float(bias), kernels.stream_of(curr))
    return out


@torch.no_grad()
def stereo_cost_volume(curr_feat, prev_feat, cv_frustum, k2s_sensor,
                       intrins, post_rots, post_trans, input_size,
                       bias: float):
    """Plane-sweep cost volume against the previous frame.

    curr_feat/prev_feat [B,N,Hc,Wc,C] stem features (prev of any float
    type: it is rounded to bf16); cv_frustum
    [D,Hc,Wc,3] tensor; k2s_sensor [B,N,4,4]; intrins/post_rots
    [B,N,3,3]; post_trans [B,N,3]; input_size (H_in, W_in). Returns the
    cost softmaxed over D, [B,N,D,Hc,Wc] f32, without gradient.
    """
    Hc, Wc = curr_feat.shape[2:4]
    az, bz, a2, b2 = homography_coeffs(cv_frustum, k2s_sensor, intrins,
                                       post_rots, post_trans, input_size,
                                       (Hc, Wc))
    depths = cv_frustum[:, 0, 0, 2].float().contiguous()
    cost = cost_volume(curr_feat.float(), prev_feat, depths, az, bz, a2, b2,
                       bias)
    return torch.softmax(-cost, dim=2)
