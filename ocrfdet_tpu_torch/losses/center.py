"""CenterHead losses (counterpart of ocrfdet_tpu/losses/center.py): a
Gaussian focal loss on the clip-sigmoided heatmaps over the count of
positives, and an L1 on the gathered box regressions weighted by the
code weights, split into xy / z / whl / yaw / vel. On one device the
cross-replica mean of the JAX package is the identity.
"""
from __future__ import annotations

from typing import Dict, List

import torch


def clip_sigmoid(x, eps: float = 1e-4):
    return torch.clamp(torch.sigmoid(x), eps, 1.0 - eps)


def gaussian_focal_loss(pred, target, alpha: float = 2.0,
                        gamma: float = 4.0):
    """Element-wise CornerNet focal loss; pred already sigmoided."""
    eps = 1e-12
    pos_w = (target == 1.0).to(pred.dtype)
    neg_w = (1.0 - target).pow(gamma)
    pos = -torch.log(pred + eps) * (1.0 - pred).pow(alpha) * pos_w
    neg = (-torch.log(1.0 - pred + eps) * pred.pow(alpha) * neg_w
           * (1.0 - pos_w))
    return pos + neg


def center_head_loss(preds: List[Dict[str, torch.Tensor]], targets,
                     code_weights, loss_bbox_weight: float = 0.25
                     ) -> Dict[str, torch.Tensor]:
    """preds: per-task dicts of channel-last maps [B,H,W,ch]; targets:
    per-task lists heatmaps [B,H,W,K], anno_boxes [B,max_objs,10], inds
    [B,max_objs], masks [B,max_objs]."""
    losses = {}
    names = ["xy", "z", "whl", "yaw", "vel"]
    splits = [0, 2, 3, 6, 8, 10]
    for t, pred in enumerate(preds):
        hm_t = targets["heatmaps"][t]
        hm_p = clip_sigmoid(pred["heatmap"].float())
        avg = torch.clamp((hm_t == 1.0).float().sum(), min=1.0)
        losses[f"task{t}.loss_heatmap"] = (
            gaussian_focal_loss(hm_p, hm_t).sum() / avg)

        anno = torch.cat([pred[k].float() for k in
                          ("reg", "height", "dim", "rot", "vel")], -1)
        B, H, W, CH = anno.shape
        anno = anno.reshape(B, H * W, CH)
        ind = targets["inds"][t].long()
        gathered = torch.gather(anno, 1, ind[..., None].expand(-1, -1, CH))
        target_box = targets["anno_boxes"][t]
        mask = targets["masks"][t][..., None].float()
        finite = torch.isfinite(target_box)
        cw = torch.tensor(code_weights, dtype=torch.float32,
                          device=anno.device)
        weights = mask * finite.float() * cw
        target_box = torch.where(finite, target_box,
                                 torch.zeros_like(target_box))
        num = torch.clamp(mask.sum(), min=1e-4)
        l1 = (gathered - target_box).abs() * weights
        for s in range(5):
            lo, hi = splits[s], splits[s + 1]
            losses[f"task{t}.loss_{names[s]}"] = (
                loss_bbox_weight * l1[..., lo:hi].sum() / (num + 1e-4))
    return losses
