"""Augmentation homographies (numpy, for the host data pipeline) and
the camera-parameter encoding (torch, for the model): counterpart of
ocrfdet_tpu/geometry/transforms.py.
  * image aug folding -> post_rot/post_tran (loading.py img_transform);
  * the BEV data-augmentation matrix (loading.py bev_transform);
  * the 27-D camera MLP input (view_transformer.py:696-721).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rot2d(h: float) -> np.ndarray:
    """The reference's clockwise 2D rotation convention
    (loading.py get_rot: [[cos, sin], [-sin, cos]])."""
    return np.array([[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]])


def fold_img_aug(resize: float, crop: Tuple[int, int, int, int],
                 flip: bool, rotate_deg: float) -> Tuple[np.ndarray, np.ndarray]:
    """Fold (resize, crop, flip, rotate) into an affine (post_rot 2x2,
    post_tran 2) mapping raw pixel coords -> augmented pixel coords.

    Mirrors loading.py:828-847: start from identity, scale by `resize`,
    shift by -crop origin, mirror about the crop width if `flip`, then
    rotate by `rotate_deg` about the crop centre.
    """
    post_rot = np.eye(2) * resize
    post_tran = -np.asarray(crop[:2], dtype=np.float64)
    if flip:
        A = np.array([[-1.0, 0.0], [0.0, 1.0]])
        b = np.array([crop[2] - crop[0], 0.0])
        post_rot = A @ post_rot
        post_tran = A @ post_tran + b
    A = rot2d(np.deg2rad(rotate_deg))
    b = np.array([crop[2] - crop[0], crop[3] - crop[1]]) / 2.0
    b = A @ (-b) + b
    post_rot = A @ post_rot
    post_tran = A @ post_tran + b
    return post_rot, post_tran


def expand_post_3x3(post_rot2: np.ndarray, post_tran2: np.ndarray):
    """Lift the 2D affine to the 3x3 (rot) + 3 (tran) used model-side
    (loading.py:1094-1098): z row/col stay identity."""
    post_rot = np.eye(3)
    post_rot[:2, :2] = post_rot2
    post_tran = np.zeros(3)
    post_tran[:2] = post_tran2
    return post_rot, post_tran


def bda_matrix(rotate_deg: float, scale: float, flip_dx: bool,
               flip_dy: bool) -> np.ndarray:
    """BEV-data-augmentation 3x3: flip @ (scale @ rot_z) (loading.py
    bev_transform:1230-1246)."""
    ang = np.deg2rad(rotate_deg)
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    scale_m = np.eye(3) * scale
    flip = np.eye(3)
    if flip_dx:
        flip = flip @ np.diag([-1.0, 1.0, 1.0])
    if flip_dy:
        flip = flip @ np.diag([1.0, -1.0, 1.0])
    return flip @ (scale_m @ rot)


def apply_bda_to_boxes(boxes: np.ndarray, rotate_deg: float, scale: float,
                       flip_dx: bool, flip_dy: bool) -> np.ndarray:
    """Apply BDA to 9-DoF boxes [x,y,z,dx,dy,dz,yaw,vx,vy]
    (loading.py:1247-1258)."""
    boxes = boxes.copy()
    if boxes.shape[0] == 0:
        return boxes.reshape(0, 9)
    rot_mat = bda_matrix(rotate_deg, scale, flip_dx, flip_dy)
    ang = np.deg2rad(rotate_deg)
    boxes[:, :3] = boxes[:, :3] @ rot_mat.T
    boxes[:, 3:6] *= scale
    boxes[:, 6] += ang
    if flip_dx:
        boxes[:, 6] = np.pi - boxes[:, 6]
    if flip_dy:
        boxes[:, 6] = -boxes[:, 6]
    if boxes.shape[1] > 7:
        boxes[:, 7:9] = boxes[:, 7:9] @ rot_mat[:2, :2].T
    return boxes


def camera_mlp_input(sensor2keyego_rot, sensor2keyego_tran, intrins,
                     post_rots, post_trans, bda):
    """27-D per-camera conditioning vector for the DepthNet SE gates.

    [fx, fy, cx, cy, post_rot row 0 + post_tran x, post_rot row 1 +
    post_tran y, bda 2x2 + z-scale, sensor2keyego 3x4 row-major].
    rot [B,N,3,3], tran [B,N,3], intrins [B,N,3,3], post_rots [B,N,3,3],
    post_trans [B,N,3], bda [B,3,3] -> [B,N,27].
    """
    B, N = intrins.shape[:2]
    bda_bn = bda[:, None].expand(B, N, 3, 3)
    feats = torch.stack([
        intrins[:, :, 0, 0], intrins[:, :, 1, 1],
        intrins[:, :, 0, 2], intrins[:, :, 1, 2],
        post_rots[:, :, 0, 0], post_rots[:, :, 0, 1], post_trans[:, :, 0],
        post_rots[:, :, 1, 0], post_rots[:, :, 1, 1], post_trans[:, :, 1],
        bda_bn[:, :, 0, 0], bda_bn[:, :, 0, 1],
        bda_bn[:, :, 1, 0], bda_bn[:, :, 1, 1], bda_bn[:, :, 2, 2],
    ], dim=-1)
    s2e = torch.cat([sensor2keyego_rot, sensor2keyego_tran[..., None]], dim=-1)
    return torch.cat([feats, s2e.reshape(B, N, 12)], dim=-1)
