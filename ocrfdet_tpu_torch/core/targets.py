"""CenterHead training targets, host-side numpy (a copy of
ocrfdet_tpu/core/targets.py, so that the port needs no JAX package).

Targets depend only on the (augmented) GT boxes, so they are computed in
numpy per sample and fed to the step as padded arrays. The Gaussian
radius and drawing follow the CornerNet / CenterPoint formulation.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..config import CenterHeadConfig, GridConfig


def gaussian_radius(det_size: Tuple[float, float],
                    min_overlap: float) -> float:
    height, width = det_size
    a1 = 1
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * a1 * c1)) / 2

    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 4 * a2 * c2)) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def draw_gaussian(heatmap: np.ndarray, center: Tuple[int, int], radius: int):
    """Max-composite an isotropic Gaussian of integer radius, in place."""
    diameter = 2 * radius + 1
    sigma = diameter / 6.0
    xs = np.arange(-radius, radius + 1)
    g = np.exp(-(xs[None, :] ** 2 + xs[:, None] ** 2) / (2 * sigma ** 2))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0

    x, y = center
    H, W = heatmap.shape
    left, right = min(x, radius), min(W - x, radius + 1)
    top, bottom = min(y, radius), min(H - y, radius + 1)
    if right + left <= 0 or bottom + top <= 0:
        return
    masked = heatmap[y - top:y + bottom, x - left:x + right]
    masked_g = g[radius - top:radius + bottom, radius - left:radius + right]
    np.maximum(masked, masked_g, out=masked)


def centerpoint_targets(boxes: np.ndarray, labels: np.ndarray,
                        head_cfg: CenterHeadConfig, grid: GridConfig):
    """Per-task targets of one sample from boxes [M, 9] (cx, cy,
    cz_gravity, dx, dy, dz, yaw, vx, vy) and labels [M]: dict of lists
    (one entry per task) of heatmap [Hf, Wf, K_t], anno_box
    [max_objs, 10], ind [max_objs], mask [max_objs]."""
    fw = int(round((grid.x[1] - grid.x[0])
                   / (head_cfg.voxel_size[0] * head_cfg.out_size_factor)))
    fh = int(round((grid.y[1] - grid.y[0])
                   / (head_cfg.voxel_size[1] * head_cfg.out_size_factor)))
    max_objs = head_cfg.max_objs
    heatmaps, anno_boxes, inds, masks = [], [], [], []
    class_offset = 0
    for task in head_cfg.tasks:
        K = len(task.class_names)
        heatmap = np.zeros((fh, fw, K), dtype=np.float32)
        anno_box = np.zeros((max_objs, 10), dtype=np.float32)
        ind = np.zeros((max_objs,), dtype=np.int32)
        mask = np.zeros((max_objs,), dtype=np.float32)
        sel = np.isin(labels, [class_offset + i for i in range(K)])
        t_boxes = boxes[sel]
        t_cls = labels[sel] - class_offset
        k_out = 0
        for k in range(min(t_boxes.shape[0], max_objs)):
            dx, dy = t_boxes[k, 3], t_boxes[k, 4]
            w = dx / head_cfg.voxel_size[0] / head_cfg.out_size_factor
            l = dy / head_cfg.voxel_size[1] / head_cfg.out_size_factor
            if w <= 0 or l <= 0:
                continue
            radius = gaussian_radius((l, w), head_cfg.gaussian_overlap)
            radius = max(head_cfg.min_radius, int(radius))
            cx = ((t_boxes[k, 0] - grid.x[0])
                  / head_cfg.voxel_size[0] / head_cfg.out_size_factor)
            cy = ((t_boxes[k, 1] - grid.y[0])
                  / head_cfg.voxel_size[1] / head_cfg.out_size_factor)
            xi, yi = int(cx), int(cy)
            if not (0 <= xi < fw and 0 <= yi < fh):
                continue
            draw_gaussian(heatmap[:, :, int(t_cls[k])], (xi, yi), radius)
            ind[k_out] = yi * fw + xi
            mask[k_out] = 1.0
            dim = t_boxes[k, 3:6]
            if head_cfg.norm_bbox:
                dim = np.log(dim)
            rot = t_boxes[k, 6]
            anno_box[k_out] = np.concatenate([
                [cx - xi, cy - yi, t_boxes[k, 2]], dim,
                [np.sin(rot), np.cos(rot)], t_boxes[k, 7:9]])
            k_out += 1
        heatmaps.append(heatmap)
        anno_boxes.append(anno_box)
        inds.append(ind)
        masks.append(mask)
        class_offset += K
    return dict(heatmaps=heatmaps, anno_boxes=anno_boxes, inds=inds,
                masks=masks)


def stack_targets(samples: Sequence[dict]):
    """Stack per-sample target dicts into batched arrays (lists stay
    per task)."""
    out = {}
    for key in ("heatmaps", "anno_boxes", "inds", "masks"):
        n_tasks = len(samples[0][key])
        out[key] = [np.stack([s[key][t] for s in samples])
                    for t in range(n_tasks)]
    return out
