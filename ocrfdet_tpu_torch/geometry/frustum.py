"""Frustum / voxel-grid geometry for the LSS splat and the HT branch
(counterpart of ocrfdet_tpu/geometry/frustum.py).

The templates (`sid_depth_bins`, `make_frustum`, `ht_reference_points`)
are numpy constants built from the config; the projections are torch
tensor functions on channel-last [..., 3] points.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.cuda_graph import constant


def sid_depth_bins(depth_cfg: Tuple[float, float, float]) -> np.ndarray:
    """Spacing-increasing depth bin centres, D = len(arange(*depth_cfg)).

    d_i = exp(log(lo) + i/(D-1) * log((hi-1)/lo)), i in [0, D).
    """
    lo, hi, step = depth_cfg
    D = len(np.arange(lo, hi, step))
    i = np.arange(D, dtype=np.float64)
    return np.exp(np.log(lo) + i / (D - 1) * np.log((hi - 1.0) / lo))


def make_frustum(depth_cfg, input_size, downsample) -> np.ndarray:
    """[D, fH, fW, 3] template of (x_pix, y_pix, depth_m) in the raw
    (augmented) input-image pixel frame, SID depth bins."""
    H_in, W_in = input_size
    fH, fW = H_in // downsample, W_in // downsample
    d = sid_depth_bins(depth_cfg)
    D = d.shape[0]
    out = np.empty((D, fH, fW, 3), dtype=np.float32)
    out[..., 0] = np.linspace(0, W_in - 1, fW)[None, None, :]
    out[..., 1] = np.linspace(0, H_in - 1, fH)[None, :, None]
    out[..., 2] = d[:, None, None]
    return out


def _inv(m):
    """torch.linalg.inv without its check for singular matrices, which
    reads the device's status on the host (and so cannot be captured
    in a CUDA graph): the same inverse, not finite where m is singular,
    as the JAX package's."""
    return torch.linalg.inv_ex(m).inverse


def frustum_to_ego(frustum, rots, trans, intrins, post_rots, post_trans, bda):
    """Frustum template -> points in the (BDA-augmented) key-ego frame.

    frustum [D,fH,fW,3]; rots/intrins/post_rots [B,N,3,3];
    trans/post_trans [B,N,3]; bda [B,3,3]. Returns [B,N,D,fH,fW,3].
    """
    pts = frustum[None, None] - post_trans[:, :, None, None, None, :]
    pts = torch.einsum('bnij,bndhwj->bndhwi', _inv(post_rots), pts)
    # un-project: (u*d, v*d, d)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    combine = rots @ _inv(intrins)
    pts = torch.einsum('bnij,bndhwj->bndhwi', combine, pts)
    pts = pts + trans[:, :, None, None, None, :]
    return torch.einsum('bij,bndhwj->bndhwi', bda, pts)


def voxel_indices(coor, grid_lower, grid_interval, grid_size):
    """Ego-frame points -> integer voxel indices + validity mask.

    coor [..., 3]; returns (idx [..., 3] int32 (x,y,z), valid [...]).
    The cast truncates toward zero, as the reference's .long() does, so
    fractional coordinates in (-1, 0) land in cell 0 and are kept.
    """
    lower = constant(grid_lower, coor.dtype, coor.device)
    step = constant(grid_interval, coor.dtype, coor.device)
    idx = ((coor - lower) / step).to(torch.int32)
    valid = ((idx[..., 0] >= 0) & (idx[..., 0] < grid_size[0]) &
             (idx[..., 1] >= 0) & (idx[..., 1] < grid_size[1]) &
             (idx[..., 2] >= 0) & (idx[..., 2] < grid_size[2]))
    return idx, valid


def ht_reference_points(bev_h: int, bev_w: int, num_height: int = 13,
                        z_pillar: float = 8.0) -> np.ndarray:
    """Normalised [0,1]^3 sample points of the height-trick branch,
    [Z, bev_h*bev_w, 3]: per pillar 5 heights linspace(3, Z-1) then
    num_height-5 heights linspace(0.5, Z-0.5), all divided by Z."""
    zs_l = np.linspace(3.0, z_pillar - 1.0, 5)
    zs_g = np.linspace(0.5, z_pillar - 0.5, num_height - 5)
    zs = np.concatenate([zs_l, zs_g]) / z_pillar
    xs = (np.arange(bev_w) + 0.5) / bev_w
    ys = (np.arange(bev_h) + 0.5) / bev_h
    out = np.empty((num_height, bev_h, bev_w, 3), dtype=np.float32)
    out[..., 0] = xs[None, None, :]
    out[..., 1] = ys[None, :, None]
    out[..., 2] = zs[:, None, None]
    return out.reshape(num_height, bev_h * bev_w, 3)


def ego_to_image(rots, trans, intrins, post_rots, post_trans, bda):
    """The (BDA-aware) ego->image projection of the HT branch.

    Returns (lidar2img [B,N,3,4], img_aug [B,N,3,4]): a homogeneous ego
    point X projects to p = lidar2img[..., :3] @ X + lidar2img[..., 3],
    then (u, v) = img_aug applied to (p.xy / p.z, p.z, 1).
    """
    B, N = rots.shape[:2]
    bda_bn = bda[:, None].expand(B, N, 3, 3)
    inv_rot = _inv(rots)
    R = intrins @ inv_rot @ _inv(bda_bn)
    t = -(intrins @ inv_rot @ trans[..., None])
    lidar2img = torch.cat([R, t], dim=-1)
    img_aug = torch.cat([post_rots, post_trans[..., None]], dim=-1)
    return lidar2img, img_aug


def project_points(ref_points, pc_range, depth_range, lidar2img, img_aug,
                   image_size):
    """Project normalised grid points into every camera.

    ref_points [Z, Nq, 3] in [0,1]^3; lidar2img/img_aug [B,N,3,4].
    Returns uvd [B,N,Z,Nq,3] (u, v normalised to the [0,1] image, d to
    [0,1] over depth_range) and valid [B,N,Z,Nq] bool (in front of the
    camera, strictly inside the image and the depth range). The
    operations and their order are the JAX package's, in fp32, so that
    the nearest-index rounding downstream (ops/ht_pool.py) agrees.
    """
    pc = constant(pc_range, torch.float32, ref_points.device)
    p = ref_points * (pc[3:6] - pc[0:3]) + pc[0:3]          # [Z,Nq,3]
    Z, Nq = p.shape[:2]
    B, N = lidar2img.shape[:2]
    p = p.reshape(Z * Nq, 3)
    cam = torch.einsum('bnij,kj->bnki', lidar2img[..., :3], p) \
        + lidar2img[..., None, :, 3]
    eps = 1e-5
    depth = cam[..., 2:3]
    in_front = depth > eps
    uv1 = torch.cat([cam[..., 0:2] / torch.clamp(depth, min=eps),
                     depth, torch.ones_like(depth)], dim=-1)
    uv = torch.einsum('bnij,bnkj->bnki', img_aug, uv1)[..., 0:2]
    H, W = image_size
    u = uv[..., 0] / W
    v = uv[..., 1] / H
    d = (depth[..., 0] - depth_range[0]) / (depth_range[1] - depth_range[0])
    valid = (in_front[..., 0] & (u > 0.0) & (u < 1.0) & (v > 0.0)
             & (v < 1.0) & (d > 0.0) & (d < 1.0))
    uvd = torch.stack([u, v, d], dim=-1).reshape(B, N, Z, Nq, 3)
    return uvd, valid.reshape(B, N, Z, Nq)
