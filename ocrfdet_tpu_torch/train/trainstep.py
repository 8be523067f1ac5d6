"""Loss assembly (counterpart of ocrfdet_tpu/train/trainstep.py): the
depth and semantic losses, the BEV mask and opacity losses, the render
losses and the CenterHead losses of every task, in one dict. On one
device the JAX package's cross-replica mean (`mean_fn`) is the identity.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import OcRFDetConfig
from ..losses.center import center_head_loss
from ..losses.depth import build_depth_semantic_labels, depth_semantic_loss
from ..losses.mask import bev_mask_loss
from ..losses.render import render_losses
from ..models.ocrf.fusion import bev_centerness_weight


def compute_losses(cfg: OcRFDetConfig, preds, aux,
                   batch) -> Dict[str, torch.Tensor]:
    losses: Dict[str, torch.Tensor] = {}
    B, N = batch["gt_depth"].shape[:2]
    h = cfg.data.input_size[0] // cfg.vt.downsample
    w = cfg.data.input_size[1] // cfg.vt.downsample
    D = cfg.grid.num_depth_bins
    gt_depth = batch["gt_depth"].reshape(B * N, *batch["gt_depth"].shape[2:])
    gt_sem = batch["gt_semantic"].reshape(B * N,
                                          *batch["gt_semantic"].shape[2:])
    d_onehot, s_onehot, valid = build_depth_semantic_labels(
        gt_depth, gt_sem, cfg.grid.depth, D, cfg.vt.downsample)
    dl, sl = depth_semantic_loss(
        aux["depth"].reshape(B * N, h, w, D),
        aux["semantic"].reshape(B * N, h, w, 2), d_onehot, s_onehot, valid,
        cfg.vt.loss_depth_weight, cfg.vt.loss_semantic_weight)
    losses["loss_depth"] = dl
    losses["loss_ce_semantic"] = sl

    centerness = torch.from_numpy(bev_centerness_weight(
        cfg.vt.bev_h, cfg.vt.bev_w)).float().to(gt_depth.device)
    for key, names in (("bev_mask_logit", ("mask_ce_loss",
                                           "mask_dice_loss")),
                       ("opacity_bev_logit", ("mask_ce_opacity_loss",
                                              "mask_dice_opacity_loss"))):
        if key in aux:
            ce, dice = bev_mask_loss(aux[key], batch["gt_bev_mask"],
                                     centerness)
            losses[names[0]] = ce
            losses[names[1]] = dice

    if "render_img" in aux:
        losses.update(render_losses(
            aux["render_img"], aux["render_img_g"], aux["render_img_n"],
            aux["render_gt_img"], aux["render_depth"],
            aux["render_depth_g"], aux["render_depth_n"],
            aux["render_gt_depth"], batch["render_box_mask"],
            batch["use_box_mask"]))

    tgts = {k: batch[k] for k in ("heatmaps", "anno_boxes", "inds", "masks")}
    losses.update(center_head_loss(preds, tgts, cfg.head.code_weights,
                                   loss_bbox_weight=cfg.head.loss_bbox_weight))
    return losses


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(v.float() for v in losses.values())
