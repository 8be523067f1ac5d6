"""CenterPoint box decoding on the device: top-K + gather (counterpart
of ocrfdet_tpu/core/coder.py).

Per task: top-K of the sigmoided heatmap across classes, gather the
regressions there, rebuild metric boxes [cx, cy, z, dx, dy, dz, yaw,
vx, vy], and flag each box valid by score threshold and post-centre
range. NMS runs on the host after decode.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch


class DecodedBoxes(NamedTuple):
    boxes: torch.Tensor    # [B, K, 9]
    scores: torch.Tensor   # [B, K]
    labels: torch.Tensor   # [B, K] task-local class ids
    valid: torch.Tensor    # [B, K] bool


def decode_task(pred: Dict[str, torch.Tensor], max_num: int,
                out_size_factor: int, voxel_size, pc_range,
                post_center_range, score_threshold: float) -> DecodedBoxes:
    heat = torch.sigmoid(pred["heatmap"].float())
    B, H, W, K = heat.shape
    scores, topk = torch.topk(heat.reshape(B, H * W * K), max_num, dim=-1)
    labels = topk % K
    pix = topk // K
    ys = (pix // W).float()
    xs = (pix % W).float()

    def gather(name):
        v = pred[name].float()
        c = v.shape[-1]
        return torch.gather(v.reshape(B, H * W, c), 1,
                            pix[..., None].expand(B, max_num, c))

    reg = gather("reg")
    height = gather("height")[..., 0]
    dim = torch.exp(gather("dim"))
    rot = gather("rot")
    vel = gather("vel")
    yaw = torch.atan2(rot[..., 0], rot[..., 1])
    cx = (xs + reg[..., 0]) * out_size_factor * voxel_size[0] + pc_range[0]
    cy = (ys + reg[..., 1]) * out_size_factor * voxel_size[1] + pc_range[1]
    boxes = torch.cat([cx[..., None], cy[..., None], height[..., None], dim,
                       yaw[..., None], vel], dim=-1)
    pcr = torch.tensor(post_center_range, dtype=boxes.dtype,
                       device=boxes.device)
    centers = boxes[..., :3]
    in_range = ((centers >= pcr[:3]).all(-1) & (centers <= pcr[3:]).all(-1))
    valid = in_range & (scores > score_threshold)
    return DecodedBoxes(boxes=boxes, scores=scores, labels=labels,
                        valid=valid)


def decode_all_tasks(preds: List[Dict[str, torch.Tensor]], head_cfg,
                     grid) -> List[DecodedBoxes]:
    return [
        decode_task(p, head_cfg.max_num, head_cfg.out_size_factor,
                    head_cfg.voxel_size, (grid.x[0], grid.y[0]),
                    head_cfg.post_center_range, head_cfg.score_threshold)
        for p in preds
    ]
