"""Host-side BEV NMS (rotated + circle) and the Scale-NMS task merge, in
numpy alone.

A frozen copy of the port's `ops/nms.py` without its C++ path: the
rotated IoU is worked out for all pairs at once (the corners of each box
inside the other and the crossings of their edges, sorted by angle
around their mean, then the shoelace area), where the port clips
polygons one pair at a time in C++.

Scale-NMS (class-wise box rescaling before NMS, then un-scaling) and
the cross-task merge follow CenterHead.get_task_detections / get_bboxes
of the reference.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _box_corners(boxes: np.ndarray) -> np.ndarray:
    """[N, 5] (cx, cy, dx, dy, yaw) -> [N, 4, 2] corner polygons."""
    cx, cy, dx, dy, yaw = boxes.T
    cos, sin = np.cos(yaw), np.sin(yaw)
    hx, hy = dx / 2, dy / 2
    local = np.stack([
        np.stack([hx, hy], -1), np.stack([-hx, hy], -1),
        np.stack([-hx, -hy], -1), np.stack([hx, -hy], -1)], axis=1)
    rot = np.stack([np.stack([cos, -sin], -1),
                    np.stack([sin, cos], -1)], axis=1)   # [N,2,2]
    pts = np.einsum('nij,nkj->nki', rot, local)
    pts[..., 0] += cx[:, None]
    pts[..., 1] += cy[:, None]
    return pts


def _inside(p, poly):
    """p [P,K,2] points, poly [P,4,2] counter-clockwise: [P,K]."""
    e0 = poly[:, None]                                # [P,1,4,2]
    ed = np.roll(poly, -1, axis=-2)[:, None] - e0
    d = p[:, :, None] - e0                            # [P,K,4,2]
    cross = ed[..., 0] * d[..., 1] - ed[..., 1] * d[..., 0]
    return (cross >= -1e-12).all(-1)


def _pair_intersection(ca, cb):
    """Intersection areas of the convex quads ca, cb [P,4,2]."""
    P = len(ca)
    in_a, in_b = _inside(ca, cb), _inside(cb, ca)
    # crossings of A's edge i with B's edge j
    p, r = ca[:, :, None], (np.roll(ca, -1, 1) - ca)[:, :, None]
    q, s = cb[:, None], (np.roll(cb, -1, 1) - cb)[:, None]
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q - p
    par = np.abs(rxs) <= 1e-12
    safe = np.where(par, 1.0, rxs)
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / safe
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / safe
    hit = ~par & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    cross = (p + t[..., None] * r).reshape(P, 16, 2)
    pts = np.concatenate([ca, cb, cross], axis=1)     # [P,24,2]
    ok = np.concatenate([in_a, in_b, hit.reshape(P, 16)], axis=1)
    cnt = ok.sum(-1)
    mean = (pts * ok[..., None]).sum(1) / np.maximum(cnt, 1)[:, None]
    rel = pts - mean[:, None]
    ang = np.where(ok, np.arctan2(rel[..., 1], rel[..., 0]), np.inf)
    order = np.argsort(ang, axis=-1)
    pts = np.take_along_axis(pts, order[..., None], axis=1)
    ok = np.take_along_axis(ok, order, axis=1)
    pts = np.where(ok[..., None], pts, pts[:, :1])    # pad with the first
    nxt = np.roll(pts, -1, axis=1)
    area = 0.5 * np.abs((pts[..., 0] * nxt[..., 1]
                         - pts[..., 1] * nxt[..., 0]).sum(-1))
    return np.where(cnt >= 3, area, 0.0)


def rotated_iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray
                       ) -> np.ndarray:
    """Exact IoU of rotated BEV rectangles [*,5] (cx, cy, dx, dy, yaw),
    worked out for the pairs whose circumscribed circles meet."""
    a = np.asarray(boxes_a, np.float64)
    b = np.asarray(boxes_b, np.float64)
    iou = np.zeros((len(a), len(b)))
    if len(a) == 0 or len(b) == 0:
        return iou
    ra = 0.5 * np.hypot(a[:, 2], a[:, 3])
    rb = 0.5 * np.hypot(b[:, 2], b[:, 3])
    dist = np.hypot(a[:, None, 0] - b[None, :, 0], a[:, None, 1] - b[None, :, 1])
    ia, ib = np.nonzero(dist <= ra[:, None] + rb[None] + 1e-9)
    inter = _pair_intersection(_box_corners(a)[ia], _box_corners(b)[ib])
    union = a[ia, 2] * a[ia, 3] + b[ib, 2] * b[ib, 3] - inter
    iou[ia, ib] = np.where(union > 1e-12, inter / np.maximum(union, 1e-12),
                           0.0)
    return iou


def nms_rotated(boxes: np.ndarray, scores: np.ndarray, iou_thr: float,
                pre_max_size: int | None = None,
                post_max_size: int | None = None) -> np.ndarray:
    """Greedy rotated NMS; boxes [N, 5] (cx, cy, dx, dy, yaw). Returns
    the kept indices, best score first."""
    order = np.argsort(-scores)
    if pre_max_size is not None:
        order = order[:pre_max_size]
    iou = rotated_iou_matrix(boxes[order], boxes[order])
    n = len(order)
    suppressed = np.zeros(n, dtype=bool)
    keep = []
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(order[i])
        suppressed |= iou[i] > iou_thr
        suppressed[i] = True
    keep = np.asarray(keep, dtype=np.int64)
    if post_max_size is not None:
        keep = keep[:post_max_size]
    return keep


def circle_nms(centers_scores: np.ndarray, radius_thr: float,
               post_max_size: int = 83) -> np.ndarray:
    """Centre-distance NMS [N, 3] (x, y, score); squared-distance
    threshold as in the reference."""
    x, y, scores = centers_scores.T
    order = np.argsort(-scores)
    suppressed = np.zeros(len(order), dtype=bool)
    keep = []
    for oi, i in enumerate(order):
        if suppressed[i]:
            continue
        keep.append(i)
        d2 = (x[i] - x[order[oi + 1:]]) ** 2 + (y[i] - y[order[oi + 1:]]) ** 2
        suppressed[order[oi + 1:][d2 <= radius_thr]] = True
    return np.asarray(keep[:post_max_size], dtype=np.int64)


def multi_task_nms(task_results: List[Dict[str, np.ndarray]], head_cfg) -> Dict[str, np.ndarray]:
    """Scale-NMS over the decoded tasks of ONE sample, then merge.

    task_results[t]: dict(boxes [K,9], scores [K], labels [K], valid
    [K]) from core.coder.decode_task as numpy (thresholded via
    `valid`). Returns dict(boxes [M,9] with bottom-centre z, scores [M],
    labels [M] global class ids).
    """
    merged_boxes, merged_scores, merged_labels = [], [], []
    class_offset = 0
    for t, res in enumerate(task_results):
        m = res["valid"].astype(bool)
        boxes = res["boxes"][m].copy()
        scores = res["scores"][m]
        labels = res["labels"][m]
        n_cls = len(head_cfg.tasks[t].class_names)
        if len(boxes):
            if head_cfg.nms_type[t] == "circle":
                radius = head_cfg.circle_nms_min_radius[t]
                keep = circle_nms(
                    np.concatenate([boxes[:, :2], scores[:, None]], -1),
                    radius, post_max_size=head_cfg.post_max_size)
            else:
                factor = head_cfg.nms_rescale_factor[t]
                scaled = boxes.copy()
                if isinstance(factor, (tuple, list)):
                    for cid, f in enumerate(factor):
                        scaled[labels == cid, 3:6] *= f
                else:
                    scaled[:, 3:6] *= factor
                bev = scaled[:, [0, 1, 3, 4, 6]]
                keep = nms_rotated(
                    bev, scores, head_cfg.nms_thr[t],
                    pre_max_size=head_cfg.pre_max_size,
                    post_max_size=head_cfg.post_max_size)
            boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
        merged_boxes.append(boxes)
        merged_scores.append(scores)
        merged_labels.append(labels + class_offset)
        class_offset += n_cls
    boxes = (np.concatenate(merged_boxes)
             if merged_boxes else np.zeros((0, 9)))
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, 2] -= boxes[:, 5] * 0.5   # gravity -> bottom centre
    return dict(
        boxes=boxes,
        scores=(np.concatenate(merged_scores)
                if merged_scores else np.zeros((0,))),
        labels=(np.concatenate(merged_labels)
                if merged_labels else np.zeros((0,), dtype=np.int64)))
