"""The camera-parameter encoding of the model (torch): counterpart of
ocrfdet_tpu/geometry/transforms.py, whose host augmentation helpers are
not copied.
  * the 27-D camera MLP input (view_transformer.py:696-721).
"""
from __future__ import annotations

import torch


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
