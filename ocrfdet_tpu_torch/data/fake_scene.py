"""Learnable synthetic world for the generalization proof (a copy of
ocrfdet_tpu/data/fake_scene.py).

The noise-image fake-nuScenes (fake_nuscenes.py) is enough for
memorization proofs but carries ZERO image->box signal: a model cannot
generalize from noise to unseen noise, so held-out mAP is 0 by
construction. This module builds a temporally-coherent scene whose
images DEPICT the annotations, so a detector that learns the mapping
scores on held-out samples too (VERDICT r4 "Next #2"):

  * persistent objects: each scene holds K cuboid objects with
    class-dependent sizes/colors and constant planar velocities; sample
    s observes the scene at t = 0.5 s with the ego translated 2 m/s
    forward — so temporal fusion and velocity regression have real
    signal, and the stereo cost volume sees geometrically consistent
    adjacent frames.
  * painter's-algorithm rasterization: cuboid faces of all objects are
    filled far-to-near with per-face Lambert-ish shading into the RGB
    image, a float depth buffer, and a class-index buffer.
  * a global-frame checkerboard ground plane (and horizon sky) — a
    static texture that moves correctly under ego motion, giving the
    plane-sweep stereo real structure to match.
  * point labels sampled from the rendered depth/class buffers (ground
    hits get class -1 and exact ray-plane depth), mirroring real lidar
    supervision instead of random numbers.

Pure numpy + PIL; no dependency on the model code. Conventions match
data/fake_nuscenes.py: ego frame x fwd / y left / z up with the ground
at z = 0; camera frame x right / y down / z fwd; ann boxes in key-ego
coordinates with bottom-centre z (data/infos.py ann_arrays).
"""
from __future__ import annotations

import colorsys
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
from PIL import Image, ImageDraw

# class -> (l, w, h) base dims, nuScenes class order
# (config.py class_names: car, truck, construction_vehicle, bus,
#  trailer, barrier, motorcycle, pedestrian, traffic_cone, bicycle)
CLASS_DIMS = np.array([
    [4.6, 1.9, 1.7], [7.0, 2.5, 2.8], [6.0, 2.8, 3.2], [11.0, 2.9, 3.5],
    [10.0, 2.9, 3.8], [2.0, 0.5, 1.0], [2.1, 0.8, 1.5], [0.7, 0.7, 1.8],
    [0.4, 0.4, 1.1], [1.7, 0.6, 1.4]], np.float64)

_FACES = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
          (2, 3, 7, 6), (1, 2, 6, 5), (0, 3, 7, 4)]
_FACE_SHADE = [0.95, 0.95, 0.80, 0.80, 1.15, 0.70]  # sides/top/bottom


def class_color(c: int, jitter: float = 0.0) -> np.ndarray:
    h = (c / 10.0 + jitter * 0.03) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.75, 0.85)
    return np.array([r, g, b]) * 255.0


@dataclass
class SceneObject:
    center0: np.ndarray     # [3] global, bottom-centre z
    dims: np.ndarray        # [3] (l, w, h)
    yaw: float              # global yaw (around +z, from +x)
    vel: np.ndarray         # [2] global planar velocity m/s
    cls: int
    shade: float            # per-object brightness jitter


def make_scene_objects(rng: np.random.Generator, n_objects: int
                       ) -> List[SceneObject]:
    objs = []
    for _ in range(n_objects):
        c = int(rng.integers(0, 10))
        dims = CLASS_DIMS[c] * rng.uniform(0.85, 1.15, 3)
        moving = (c in (0, 1, 3, 6, 9)) and rng.random() < 0.6
        speed = rng.uniform(2.0, 8.0) if moving else 0.0
        yaw = float(rng.uniform(-np.pi, np.pi))
        vel = speed * np.array([np.cos(yaw), np.sin(yaw)])
        objs.append(SceneObject(
            center0=np.array([rng.uniform(-48, 48), rng.uniform(-48, 48),
                              0.0]),
            dims=dims, yaw=yaw, vel=vel, cls=c,
            shade=float(rng.uniform(0.85, 1.15))))
    return objs


def boxes_at(objs: List[SceneObject], t: float,
             ego_xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[M,9] key-ego boxes (bottom-centre z, yaw, vxy) + labels at
    time t for an ego at ego_xyz (identity ego rotation)."""
    boxes = np.zeros((len(objs), 9), np.float32)
    labels = np.zeros(len(objs), np.int64)
    for i, o in enumerate(objs):
        c = o.center0.copy()
        c[:2] += o.vel * t
        boxes[i, 0:3] = c - ego_xyz
        boxes[i, 3:6] = o.dims
        boxes[i, 6] = o.yaw
        boxes[i, 7:9] = o.vel
        labels[i] = o.cls
    return boxes, labels


def _corners_global(o: SceneObject, t: float) -> np.ndarray:
    """[8,3] cuboid corners in the global frame at time t. Corner order:
    bottom ring 0-3 (x±l/2, y±w/2 in object frame), top ring 4-7."""
    l, w, h = o.dims
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * (l / 2)
    sy = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * (w / 2)
    sz = np.array([0, 0, 0, 0, 1, 1, 1, 1]) * h
    cz, sn = np.cos(o.yaw), np.sin(o.yaw)
    gx = cz * sx - sn * sy
    gy = sn * sx + cz * sy
    c = o.center0.copy()
    c[:2] += o.vel * t
    return np.stack([c[0] + gx, c[1] + gy, c[2] + sz], axis=-1)


def render_camera(objs: List[SceneObject], t: float,
                  ego_xyz: np.ndarray, cam_rot: np.ndarray,
                  cam_trans: np.ndarray, K: np.ndarray,
                  img_hw: Tuple[int, int],
                  rng: np.random.Generator,
                  n_points: int = 400):
    """Render one camera view. cam_rot/cam_trans: cam->ego (ego frame
    at this sample, i.e. ego_xyz already removed from world coords).

    Returns (rgb uint8 [H,W,3], point_label [4, n_points]) where
    point_label rows are (x_pix, y_pix, depth_m, class; ground -1).
    """
    H, W = img_hw
    R = cam_rot            # cam -> ego
    Rt = R.T               # ego -> cam
    cam_pos = cam_trans    # in ego frame

    # ---- background: sky + checkerboard ground via per-pixel rays
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    Kinv = np.linalg.inv(K)
    d_cam = np.stack([u, v, np.ones_like(u)], -1) @ Kinv.T   # [H,W,3]
    d_ego = d_cam @ R.T
    # ground plane z=0 (ego): cam_pos_z + t*dz = 0, t>0 and dz<0
    dz = d_ego[..., 2]
    t_hit = np.where(dz < -1e-6, -cam_pos[2] / np.where(dz < -1e-6, dz,
                                                        -1.0), np.inf)
    ground = np.isfinite(t_hit) & (t_hit > 0)
    t_fin = np.where(ground, t_hit, 0.0)
    gx = cam_pos[0] + t_fin * d_ego[..., 0] + ego_xyz[0]
    gy = cam_pos[1] + t_fin * d_ego[..., 1] + ego_xyz[1]
    checker = ((np.floor(gx / 2.0) + np.floor(gy / 2.0)) % 2.0)
    img = np.empty((H, W, 3), np.float64)
    img[...] = np.array([168.0, 192.0, 224.0])        # sky
    gcol = 88.0 + 14.0 * checker
    # fade the checker with distance (keeps far ground from aliasing
    # into high-frequency noise the JPEG mangles)
    fade = np.clip(1.0 - t_hit / 80.0, 0.0, 1.0)
    for ch, base in enumerate((1.00, 0.98, 0.94)):
        img[..., ch] = np.where(
            ground, (76.0 + (gcol - 76.0) * fade) * base, img[..., ch])
    # depth buffer: camera-frame z of the visible surface; sky = inf
    depth = np.where(ground, t_hit * d_cam[..., 2], np.inf)
    clsbuf = np.full((H, W), -1.0)                    # ground class
    clsbuf[~ground] = -2.0                            # sky: no label

    # ---- cuboids, painter's algorithm over faces of all objects
    im = Image.fromarray(img.astype(np.uint8))
    dr = ImageDraw.Draw(im)
    dim = Image.fromarray(np.where(np.isfinite(depth), depth,
                                   0.0).astype(np.float32), mode="F")
    ddr = ImageDraw.Draw(dim)
    cim = Image.fromarray(clsbuf.astype(np.float32), mode="F")
    cdr = ImageDraw.Draw(cim)

    faces = []
    for o in objs:
        cg = _corners_global(o, t)                     # [8,3] global
        ce = cg - ego_xyz[None, :]                     # ego frame
        cc = (ce - cam_pos[None, :]) @ Rt.T            # camera frame
        if np.all(cc[:, 2] < 0.5):
            continue
        for fi, f in enumerate(_FACES):
            z = cc[list(f), 2]
            if np.any(z < 0.3):          # partially behind: skip face
                continue
            pts = cc[list(f)]
            uvf = (pts @ K.T)
            uvf = uvf[:, :2] / uvf[:, 2:3]
            if (uvf[:, 0].max() < 0 or uvf[:, 0].min() > W
                    or uvf[:, 1].max() < 0 or uvf[:, 1].min() > H):
                continue
            col = np.clip(class_color(o.cls) * _FACE_SHADE[fi]
                          * o.shade, 0, 255)
            faces.append((float(z.mean()), uvf, col, o.cls))
    faces.sort(key=lambda x: -x[0])                    # far first
    for z, uvf, col, c in faces:
        poly = [(float(a), float(b)) for a, b in uvf]
        dr.polygon(poly, fill=tuple(int(x) for x in col))
        ddr.polygon(poly, fill=float(z))
        cdr.polygon(poly, fill=float(c))

    rgb = np.asarray(im, np.float64)
    rgb = rgb + rng.normal(0.0, 3.0, rgb.shape)        # sensor noise
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    depth = np.asarray(dim, np.float64)
    clsbuf = np.asarray(cim, np.float64)

    # ---- point labels from the rendered buffers (lidar analog):
    # biased toward objects so sparse depth supervision hits them
    ys_o, xs_o = np.nonzero(clsbuf >= 0)
    n_obj = min(n_points // 2, ys_o.size)
    sel = rng.choice(ys_o.size, n_obj, replace=False) if n_obj else []
    ys_g, xs_g = np.nonzero((clsbuf == -1.0) & (depth > 0.5)
                            & (depth < 60.0))
    n_gnd = min(n_points - n_obj, ys_g.size)
    sel_g = rng.choice(ys_g.size, n_gnd, replace=False) if n_gnd else []
    xs = np.concatenate([xs_o[sel], xs_g[sel_g]]).astype(np.float64)
    ys = np.concatenate([ys_o[sel], ys_g[sel_g]]).astype(np.float64)
    ds = depth[ys.astype(int), xs.astype(int)]
    cs = clsbuf[ys.astype(int), xs.astype(int)]
    point_label = np.stack([xs + 0.5, ys + 0.5, ds, cs])
    return rgb, point_label
