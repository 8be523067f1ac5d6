"""Gaussian preprocessing: 3D covariance -> screen-space conics
(counterpart of ocrfdet_tpu/ops/splat/preprocess.py).

Quaternion and scale -> 3D covariance, EWA projection to a 2D conic, a
3-sigma pixel radius, the view depth and the frustum cull, for every
Gaussian of every sample at once (leading batch dim B).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...geometry.cameras import SplatCamera, ndc_to_pixel


class Gaussians2D(NamedTuple):
    mean2d: torch.Tensor   # [B, G, 2] pixel centres
    conic: torch.Tensor    # [B, G, 3] inverse-covariance upper triangle
    radius: torch.Tensor   # [B, G] float 3-sigma pixel radius (0 = culled)
    depth: torch.Tensor    # [B, G] view-space z
    valid: torch.Tensor    # [B, G] bool


def quat_scale_to_cov3d(quat, scale):
    """[..., 4] (w, x, y, z, any norm) and [..., 3] scales -> [..., 3, 3]
    covariance R diag(s)^2 R^T."""
    q = quat * torch.rsqrt((quat * quat).sum(-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
    M = R * scale[..., None, :]
    return M @ M.transpose(-1, -2)


def preprocess_gaussians(means3d, cov3d, cam: SplatCamera,
                         near: float = 0.2) -> Gaussians2D:
    """Project the Gaussians of every sample into its camera: means3d
    [G, 3] (shared) or [B, G, 3], cov3d [B, G, 3, 3], cam fields [B, ...]."""
    B, G = cov3d.shape[:2]
    means3d = means3d.expand(B, G, 3)
    p_h = torch.cat([means3d, torch.ones_like(means3d[..., :1])], -1)
    p_view = p_h @ cam.w2c.transpose(-1, -2)              # [B, G, 4]
    tx, ty, tz = p_view[..., 0], p_view[..., 1], p_view[..., 2]
    in_front = tz > near

    p_clip = p_view @ cam.proj.transpose(-1, -2)
    w_c = p_clip[..., 3]
    w_c = torch.where(w_c.abs() < 1e-7, torch.full_like(w_c, 1e-7), w_c)
    ndc = p_clip[..., :3] / w_c[..., None]
    mean2d = torch.stack([ndc_to_pixel(ndc[..., 0], cam.width),
                          ndc_to_pixel(ndc[..., 1], cam.height)], -1)

    # EWA: cov2d = J W Sigma W^T J^T with fov-clamped tangents
    tan_x, tan_y = cam.tan_fovx[:, None], cam.tan_fovy[:, None]
    fx = cam.width / (2.0 * tan_x)
    fy = cam.height / (2.0 * tan_y)
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))
    lim_x, lim_y = 1.3 * tan_x, 1.3 * tan_y
    txtz = torch.minimum(torch.maximum(tx / tz_safe, -lim_x), lim_x)
    tytz = torch.minimum(torch.maximum(ty / tz_safe, -lim_y), lim_y)
    zeros = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([fx / tz_safe, zeros, -fx * txtz / tz_safe], -1),
        torch.stack([zeros, fy / tz_safe, -fy * tytz / tz_safe], -1),
    ], dim=-2)                                            # [B, G, 2, 3]
    Tm = J @ cam.w2c[:, None, :3, :3]
    cov2d = Tm @ cov3d @ Tm.transpose(-1, -2)             # [B, G, 2, 2]
    # low-pass dilation: every splat covers >= ~1 pixel
    cov2d = cov2d + 0.3 * torch.eye(2, dtype=cov2d.dtype,
                                    device=cov2d.device)

    a, b, c = cov2d[..., 0, 0], cov2d[..., 0, 1], cov2d[..., 1, 1]
    det = a * c - b * b
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))
    valid = in_front & det_ok
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Gaussians2D(mean2d=mean2d, conic=conic, radius=radius, depth=tz,
                       valid=valid)
