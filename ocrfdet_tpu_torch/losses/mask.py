"""BEV mask and opacity losses (counterpart of ocrfdet_tpu/losses/mask.py):
BCE-with-logits (pos_weight 2.13) weighted by the BEV centerness map,
plus a sigmoid Dice loss, both times 6.
"""
from __future__ import annotations

import torch.nn.functional as F


def bce_with_logits(logit, target, pos_weight: float = 2.13):
    return -(pos_weight * target * F.logsigmoid(logit)
             + (1.0 - target) * F.logsigmoid(-logit))


def dice_loss(logit, target, smooth: float = 1e-5):
    p = logit.sigmoid().reshape(-1)
    t = target.reshape(-1)
    inter = (p * t).sum()
    return 1.0 - (2.0 * inter + smooth) / (p.sum() + t.sum() + smooth)


def bev_mask_loss(pred_logit, gt_mask, centerness, loss_weight: float = 6.0):
    """pred_logit [B,H,W(,1)], gt_mask [B,H,W], centerness [H,W].
    Returns (ce, dice), both weighted."""
    if pred_logit.dim() == 4:
        pred_logit = pred_logit[..., 0]
    pred_logit = pred_logit.float()
    gt = gt_mask.float()
    ce = (bce_with_logits(pred_logit, gt) * centerness[None]).mean()
    return loss_weight * ce, loss_weight * dice_loss(pred_logit, gt)
