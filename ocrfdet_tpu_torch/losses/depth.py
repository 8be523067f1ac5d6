"""Depth and semantic supervision of the view transformer (counterpart of
ocrfdet_tpu/losses/depth.py).

Labels: min-pool of the sparse depth map to the feature stride and
one-hot depth bins, semantic max-pool and a 2-class one-hot, and on
foreground pixels the histogram of the foreground points' depth bins in
place of the one-hot. Losses: BCE on the depth bins weighted 0.9 fg /
0.1 bg, focal loss (alpha 0.25, gamma 2) on the semantics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _downsample_blocks(x, ds: int):
    """[BN, H, W] -> [BN, H/ds, W/ds, ds*ds] block view."""
    BN, H, W = x.shape
    x = x.reshape(BN, H // ds, ds, W // ds, ds)
    return x.permute(0, 1, 3, 2, 4).reshape(BN, H // ds, W // ds, ds * ds)


def _bins(blocks, lo: float, step: float, num_bins: int):
    """Depth -> bin index in [0, num_bins] (0 = none), the block's zeros
    read as 1e5 (out of range)."""
    d = torch.where(blocks == 0.0, torch.full_like(blocks, 1e5), blocks)
    return d, (d - (lo - step)) / step


def build_depth_semantic_labels(gt_depth, gt_semantic, depth_cfg,
                                num_bins: int, downsample: int):
    """gt_depth / gt_semantic [BN, H, W] (0 = no point). Returns
    (depth_onehot [BN,h,w,D], semantic_onehot [BN,h,w,2], valid
    [BN,h,w])."""
    lo, hi, step = depth_cfg
    in_range = (gt_depth >= lo) & (gt_depth <= hi)
    zero = torch.zeros_like(gt_depth)
    depth = torch.where(in_range, gt_depth, zero)
    sem = torch.where(in_range, gt_semantic, zero)
    sem_depth = depth * sem

    dblk, _ = _bins(_downsample_blocks(depth, downsample), lo, step,
                    num_bins)
    dmin = dblk.amin(-1)
    dbin = (dmin - (lo - step)) / step
    dvalid = (dbin >= 0.0) & (dbin < num_bins + 1)
    dbin = torch.where(dvalid, dbin, torch.zeros_like(dbin)).to(torch.int64)
    depth_onehot = F.one_hot(dbin, num_bins + 1)[..., 1:].float()

    smax = _downsample_blocks(sem, downsample).amax(-1)
    semantic_onehot = F.one_hot(smax.to(torch.int64), 2).float()

    _, sdbin = _bins(_downsample_blocks(sem_depth, downsample), lo, step,
                     num_bins)
    sdvalid = (sdbin >= 0.0) & (sdbin < num_bins + 1)
    sdbin = torch.where(sdvalid, sdbin, torch.zeros_like(sdbin)).to(
        torch.int64)
    hist = F.one_hot(sdbin, num_bins + 1).sum(-2)[..., 1:].float()
    soft = hist / torch.clamp(hist.sum(-1, keepdim=True), min=1e-12)
    fg = smax > 0.0
    depth_onehot = torch.where(fg[..., None], soft, depth_onehot)
    valid = depth_onehot.amax(-1) > 0.0
    return depth_onehot, semantic_onehot, valid


def depth_semantic_loss(depth_pred, semantic_pred, depth_onehot,
                        semantic_onehot, valid, loss_depth_weight: float,
                        loss_semantic_weight: float):
    """depth_pred [BN,h,w,D] and semantic_pred [BN,h,w,2] (softmaxed).
    Returns (weighted depth loss, weighted semantic loss)."""
    eps = 1e-7
    sem_w = torch.where(semantic_onehot[..., 1] > 0, 0.9, 0.1)
    w = sem_w * valid.float()
    bce = -(depth_onehot * torch.log(torch.clamp(depth_pred, eps, 1.0))
            + (1.0 - depth_onehot)
            * torch.log(torch.clamp(1.0 - depth_pred, eps, 1.0)))
    depth_loss = (bce * w[..., None]).sum() / torch.clamp(w.sum(), min=0.1)

    p, t = semantic_pred, semantic_onehot
    alpha, gamma = 0.25, 2.0
    pt = (1.0 - p) * t + p * (1.0 - t)
    focal_w = (alpha * t + (1.0 - alpha) * (1.0 - t)) * pt.pow(gamma)
    sem_bce = -(t * torch.log(torch.clamp(p, eps, 1.0))
                + (1.0 - t) * torch.log(torch.clamp(1.0 - p, eps, 1.0)))
    sem_loss = (sem_bce * focal_w * valid.float()[..., None]).sum()
    n_valid = torch.clamp(valid.float().sum(), min=1.0)
    return (loss_depth_weight * depth_loss,
            loss_semantic_weight * sem_loss / n_valid)
