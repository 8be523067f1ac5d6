"""Render supervision (counterpart of ocrfdet_tpu/losses/render.py): per
sample's rendered camera, colour MSE x20 and (1 - SSIM) x1 and an L1 on
the min-max-normalised depth, each averaged over the blended,
Gaussian-only and NeRF-only renders. With `use_box_mask` > 0 the colour
losses see only the 2D box mask.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops.ssim import ssim


def render_losses(render_ng, render_g, render_n, gt_image, depth_ng,
                  depth_g, depth_n, gt_depth, box_mask, use_box_mask,
                  color_weight: float = 20.0, ssim_weight: float = 1.0,
                  depth_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    """Images [B,H,W,3] in [0,1]; depths [B,H,W]; gt_depth the sparse
    metric depth [B,H,W]; box_mask [B,H,W]."""
    m3 = torch.where(use_box_mask > 0, box_mask,
                     torch.ones_like(box_mask))[..., None]
    gt_m = gt_image * m3
    mses, ssims = [], []
    for r in (render_ng, render_g, render_n):
        rm = r * m3
        mses.append(((rm - gt_m) ** 2).mean())
        ssims.append(1.0 - ssim(rm, gt_m))
    dmin = gt_depth.amin(dim=(1, 2), keepdim=True)
    dmax = gt_depth.amax(dim=(1, 2), keepdim=True)
    gt_d = (gt_depth - dmin) / (dmax - dmin + 0.01)
    d_losses = [(d - gt_d).abs().mean() for d in (depth_ng, depth_g, depth_n)]
    return dict(loss_gs_color=color_weight * sum(mses) / 3.0,
                loss_gs_ssim=ssim_weight * sum(ssims) / 3.0,
                loss_render_depth=depth_weight * sum(d_losses) / 3.0)
