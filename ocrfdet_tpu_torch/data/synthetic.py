"""Synthetic batches (counterpart of
ocrfdet_tpu/data/synthetic.py::make_batch).

A plausible 6-camera rig (yaw-spread pinhole cameras at ego height),
random images and the camera tensors, as numpy arrays in the JAX
package's channel-last batch layout; with `with_targets` also every
training field: unnormalised images, sparse depth / semantic maps, GT
boxes and their BEV mask and CenterHead targets, the camera to render
and its 2D box mask. Everything is drawn from one numpy generator in the
JAX package's order, so for one seed each array equals the JAX
package's. The eval draw stops after `imgs` (the next draw is
`imgs_wo_norm`), so eval batches are the same with or without targets.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..config import OcRFDetConfig
from ..core import targets as TG
from ..geometry.quaternion import se3, yaw_matrix


def make_camera_rig(num_cams: int, input_size, src_size):
    """Returns (rots [N,3,3] cam->ego, trans [N,3], intrins [N,3,3])."""
    H, W = input_size
    fx = 1266.0 * W / src_size[1]   # nuScenes ~1266 px at 1600 wide
    K = np.array([[fx, 0.0, W / 2.0], [0.0, fx, H / 2.0], [0.0, 0.0, 1.0]])
    # camera axes x right, y down, z forward, mounted on the ego frame
    # (x forward, y left, z up) with spread yaw
    base = np.array([[0.0, -1.0, 0.0],
                     [0.0, 0.0, -1.0],
                     [1.0, 0.0, 0.0]]).T
    rots, trans, intrins = [], [], []
    for i in range(num_cams):
        yaw = 2.0 * np.pi * i / num_cams
        rots.append(yaw_matrix(yaw) @ base)
        trans.append(yaw_matrix(yaw) @ np.array([1.5, 0.0, 1.6]))
        intrins.append(K)
    return np.stack(rots), np.stack(trans), np.stack(intrins)


def make_batch(cfg: OcRFDetConfig, batch_size: int | None = None,
               seed: int = 0, with_targets: bool = False
               ) -> Dict[str, np.ndarray]:
    """imgs [B,F,N,H,W,3], rots/intrins/post_rots [B,F,N,3,3],
    trans/post_trans [B,F,N,3], bda [B,3,3], k2s_sensor [B,F,N,4,4],
    with_prev []; with `with_targets` also imgs_wo_norm [B,N,H,W,3],
    gt_depth/gt_semantic [B,N,H,W], gt_bev_mask [B,Y,X], the per-task
    lists heatmaps/anno_boxes/inds/masks, gt_boxes [B,12,9], gt_labels
    [B,12], render_cam [B], render_box_mask [B,H,W], use_box_mask [] and
    kd_pair [B,2]."""
    rng = np.random.default_rng(seed)
    B = batch_size or cfg.batch_size
    N = cfg.data.num_cams
    F = cfg.total_frames
    H, W = cfg.data.input_size
    rots, trans, intrins = make_camera_rig(N, cfg.data.input_size,
                                           cfg.data.src_size)
    batch: Dict[str, np.ndarray] = {}
    batch["imgs"] = rng.normal(size=(B, F, N, H, W, 3)).astype(np.float32)
    if with_targets:
        batch["imgs_wo_norm"] = rng.uniform(
            0, 255, size=(B, N, H, W, 3)).astype(np.float32)
    batch["rots"] = np.broadcast_to(rots, (B, F, N, 3, 3)).astype(np.float32)
    batch["trans"] = np.broadcast_to(trans, (B, F, N, 3)).astype(np.float32)
    batch["intrins"] = np.broadcast_to(
        intrins, (B, F, N, 3, 3)).astype(np.float32)
    batch["post_rots"] = np.broadcast_to(
        np.eye(3), (B, F, N, 3, 3)).astype(np.float32)
    batch["post_trans"] = np.zeros((B, F, N, 3), dtype=np.float32)
    batch["bda"] = np.broadcast_to(np.eye(3), (B, 3, 3)).astype(np.float32)
    # the ego moves 1 m forward per frame: k2s maps key sensor -> sweep
    k2s = np.zeros((B, F, N, 4, 4), dtype=np.float32)
    for f in range(F):
        shift = np.array([1.0 * f, 0.0, 0.0])
        for n in range(N):
            s2e = se3(rots[n], trans[n])
            s2e_shift = se3(rots[n], trans[n] + shift)
            k2s[:, f, n] = (np.linalg.inv(s2e_shift) @ s2e).astype(np.float32)
    batch["k2s_sensor"] = k2s
    batch["with_prev"] = np.asarray(1.0, dtype=np.float32)
    if with_targets:
        batch.update(_training_fields(cfg, rng, B))
    return batch


def _training_fields(cfg: OcRFDetConfig, rng, B: int):
    """The training fields, drawn after the camera tensors."""
    N = cfg.data.num_cams
    H, W = cfg.data.input_size
    out: Dict[str, np.ndarray] = {}
    # sparse depth / semantic maps (about 1% of pixels hit)
    depth = np.zeros((B, N, H, W), dtype=np.float32)
    sem = np.zeros((B, N, H, W), dtype=np.float32)
    npts = max(1, H * W // 100)
    for b in range(B):
        for n in range(N):
            ys = rng.integers(0, H, npts)
            xs = rng.integers(0, W, npts)
            depth[b, n, ys, xs] = rng.uniform(
                cfg.grid.depth[0], cfg.grid.depth[1], npts)
            sem[b, n, ys, xs] = (rng.random(npts) < 0.4).astype(np.float32)
    out["gt_depth"] = depth
    out["gt_semantic"] = sem

    # GT boxes in the key-ego frame (gravity-centred z)
    n_boxes = 12
    boxes = np.zeros((B, n_boxes, 9), dtype=np.float32)
    labels = np.zeros((B, n_boxes), dtype=np.int64)
    bev_h, bev_w = cfg.vt.bev_h, cfg.vt.bev_w
    bev_mask = np.zeros((B, bev_h, bev_w), dtype=np.float32)
    for b in range(B):
        xy = rng.uniform(-40, 40, size=(n_boxes, 2))
        boxes[b, :, 0:2] = xy
        boxes[b, :, 2] = rng.uniform(-1.0, 1.0, n_boxes)
        boxes[b, :, 3:6] = rng.uniform(1.0, 5.0, size=(n_boxes, 3))
        boxes[b, :, 6] = rng.uniform(-np.pi, np.pi, n_boxes)
        boxes[b, :, 7:9] = rng.normal(0, 2, size=(n_boxes, 2))
        labels[b] = rng.integers(0, len(cfg.class_names), n_boxes)
        # coarse BEV footprint mask
        gx = ((xy[:, 0] - cfg.grid.x[0]) / (cfg.grid.x[1] - cfg.grid.x[0])
              * bev_w).astype(int)
        gy = ((xy[:, 1] - cfg.grid.y[0]) / (cfg.grid.y[1] - cfg.grid.y[0])
              * bev_h).astype(int)
        ok = (gx >= 0) & (gx < bev_w) & (gy >= 0) & (gy < bev_h)
        bev_mask[b, gy[ok], gx[ok]] = 1.0
    out["gt_bev_mask"] = bev_mask
    out.update(TG.stack_targets([
        TG.centerpoint_targets(boxes[b], labels[b], cfg.head, cfg.grid)
        for b in range(B)]))
    out["gt_boxes"] = boxes
    out["gt_labels"] = labels
    # the camera to render per sample (OcRF branch)
    out["render_cam"] = rng.integers(0, N, size=(B,)).astype(np.int32)
    # 2D box mask on the rendered camera (random rectangles stand in for
    # projected GT boxes) and its warm-up gate
    bm = np.zeros((B, H, W), dtype=np.float32)
    for b in range(B):
        for _ in range(4):
            x0, y0 = rng.integers(0, W // 2), rng.integers(0, H // 2)
            bm[b, y0:y0 + H // 3, x0:x0 + W // 3] = 1.0
    out["render_box_mask"] = bm
    out["use_box_mask"] = np.asarray(0.0, dtype=np.float32)
    # adjacent camera pair (GeoEnhDet distillation): the rig neighbour,
    # with 3 and 5 swapped on a 6-camera rig
    i1 = rng.integers(0, N, size=(B,))
    i2 = (i1 + 1) % N
    if N == 6:
        i2 = np.where(i2 == 3, 5, np.where(i2 == 5, 3, i2))
    out["kd_pair"] = np.stack([i1, i2], -1).astype(np.int32)
    return out
