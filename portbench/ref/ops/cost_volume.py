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

from typing import Tuple

import torch


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


def cost_volume(curr, prev, depths, az, bz, a2, b2, bias: float):
    """Raw plane-sweep cost [B,N,D,H,W] f32 (the plain version)."""
    return cost_volume_plain(curr, prev, depths, az, bz, a2, b2, float(bias))


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
