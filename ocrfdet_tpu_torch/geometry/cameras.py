"""Camera model of the Gaussian-splat renderer (counterpart of
ocrfdet_tpu/geometry/cameras.py).

Column vectors (p_cam = W2C @ p_world); W2C is the inverse of the
camera-to-world pose, and the projection is the GL-style off-centre
frustum built from the intrinsics K (which may carry the image
augmentation folded in).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class SplatCamera(NamedTuple):
    """The camera of one rendered view per sample (leading dims [...])."""
    w2c: torch.Tensor         # [..., 4, 4]
    proj: torch.Tensor        # [..., 4, 4]
    cam_center: torch.Tensor  # [..., 3]
    tan_fovx: torch.Tensor    # [...]
    tan_fovy: torch.Tensor    # [...]
    height: int
    width: int


def focal2fov(focal, pixels):
    return 2.0 * torch.atan(pixels / (2.0 * focal))


def projection_matrix_from_K(K, h: int, w: int, znear: float, zfar: float):
    """K [..., 3, 3] -> P [..., 4, 4]: ndc_x = 2u/W - 1 for the
    continuous image coordinate u, so that `ndc_to_pixel` lands on the
    pixel-index grid; depth mapped to [0, 1]."""
    zeros = torch.zeros_like(K[..., 0, 0])
    ones = torch.ones_like(zeros)
    row0 = torch.stack([2.0 * K[..., 0, 0] / w, 2.0 * K[..., 0, 1] / w,
                        2.0 * K[..., 0, 2] / w - 1.0, zeros], -1)
    row1 = torch.stack([2.0 * K[..., 1, 0] / h, 2.0 * K[..., 1, 1] / h,
                        2.0 * K[..., 1, 2] / h - 1.0, zeros], -1)
    row2 = torch.stack([zeros, zeros, ones * zfar / (zfar - znear),
                        -ones * (zfar * znear) / (zfar - znear)], -1)
    row3 = torch.stack([zeros, zeros, ones, zeros], -1)
    return torch.stack([row0, row1, row2, row3], dim=-2)


def splat_camera(c2w, K, image_size: Tuple[int, int], znear: float = 0.01,
                 zfar: float = 999.9) -> SplatCamera:
    """The renderer camera from a camera-to-world pose c2w [..., 4, 4]
    and K [..., 3, 3]."""
    h, w = image_size
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    Rt = R.transpose(-1, -2)
    w2c_t = -torch.einsum("...ij,...j->...i", Rt, t)
    w2c = torch.zeros(c2w.shape[:-2] + (4, 4), dtype=c2w.dtype,
                      device=c2w.device)
    w2c[..., :3, :3] = Rt
    w2c[..., :3, 3] = w2c_t
    w2c[..., 3, 3] = 1.0
    return SplatCamera(
        w2c=w2c, proj=projection_matrix_from_K(K, h, w, znear, zfar),
        cam_center=t,
        tan_fovx=torch.tan(0.5 * focal2fov(K[..., 0, 0], float(w))),
        tan_fovy=torch.tan(0.5 * focal2fov(K[..., 1, 1], float(h))),
        height=h, width=w)


def ndc_to_pixel(ndc, size):
    """((x + 1) * size - 1) / 2, the 3DGS pixel-centre convention."""
    return ((ndc + 1.0) * size - 1.0) * 0.5
