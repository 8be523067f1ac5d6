"""Fake nuScenes-mini builder for integration tests (a copy of
ocrfdet_tpu/data/fake_nuscenes.py: for one seed it writes the same
info file and images).

Writes a miniature bevdetv2-style info pickle + JPEG images (+ point
labels) to disk so the real pipeline (infos -> PIL decode -> aug ->
targets -> collate) can be exercised without the actual dataset.
"""
from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np
from PIL import Image

from ..config import OcRFDetConfig
from ..data.synthetic import make_camera_rig


def _quat_from_matrix(R: np.ndarray):
    """Rotation matrix -> (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i + 1] = 0.25 * s
        q[0] = (R[k, j] - R[j, k]) / s
        q[j + 1] = (R[j, i] + R[i, j]) / s
        q[k + 1] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    return [float(w), float(x), float(y), float(z)]


def build_fake_nuscenes(root: str, cfg: OcRFDetConfig,
                        n_samples: int = 4, img_hw=(128, 352),
                        seed: int = 0, scene: bool = False,
                        scene_len: int = 8, n_objects: int = 20) -> str:
    """Creates root/samples/*.jpg + root/infos.pkl; returns pkl path.

    scene=False (default): noise images + random boxes — cheap fixtures
    for pipeline/memorization tests. scene=True: temporally-coherent
    RENDERED scenes (data/fake_scene.py) whose images depict the boxes
    — required for any train/held-out generalization signal. Samples
    are grouped into scenes of `scene_len` (persistent objects, ego
    moving 2 m / 0.5 s sample forward); point labels come from the
    rendered depth/class buffers.
    """
    rng = np.random.default_rng(seed)
    H, W = img_hw
    os.makedirs(os.path.join(root, "samples"), exist_ok=True)
    os.makedirs(os.path.join(root, "samples_point_label"), exist_ok=True)
    rots, trans, _ = make_camera_rig(cfg.data.num_cams, (H, W),
                                     (H, W))
    if scene:
        from .fake_scene import boxes_at, make_scene_objects, \
            render_camera
        # real nuScenes optics scaled to the written image size
        fx = 1266.0 * W / 1600.0
        K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]])
    else:
        K = np.array([[200.0, 0, W / 2], [0, 200.0, H / 2],
                      [0, 0, 1.0]])
    infos: List[dict] = []
    objs = None
    for s in range(n_samples):
        if scene:
            s_loc = s % scene_len
            if s_loc == 0:
                objs = make_scene_objects(rng, n_objects)
            t_now = 0.5 * s_loc
            ego_shift = np.array([2.0 * s_loc, 0.0, 0.0])
        else:
            ego_shift = np.array([2.0 * s, 0.0, 0.0])
        cams = {}
        for n, cam in enumerate(cfg.data.cams):
            img_name = f"samples/s{s}_c{n}.jpg"
            path = os.path.join(root, img_name)
            if scene:
                arr, pl = render_camera(objs, t_now, ego_shift,
                                        rots[n], trans[n], K,
                                        (H, W), rng)
            else:
                arr = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
                # sparse point labels [4, K]: x, y, depth, class
                npts = 200
                pl = np.stack([
                    rng.uniform(0, W, npts), rng.uniform(0, H, npts),
                    rng.uniform(2.0, 50.0, npts),
                    rng.integers(-1, 10, npts).astype(np.float64)])
            Image.fromarray(arr).save(path, quality=90)
            np.save(os.path.join(
                root, "samples_point_label", f"s{s}_c{n}.npy"), pl)
            cams[cam] = dict(
                data_path=path,
                cam_intrinsic=K.tolist(),
                sensor2ego_rotation=_quat_from_matrix(rots[n]),
                sensor2ego_translation=trans[n].tolist(),
                ego2global_rotation=_quat_from_matrix(np.eye(3)),
                ego2global_translation=ego_shift.tolist(),
                timestamp=s * 500000 + n,
            )
        if scene:
            boxes, labels = boxes_at(objs, t_now, ego_shift)
        else:
            M = 6
            boxes = np.zeros((M, 9), np.float32)
            boxes[:, 0:2] = rng.uniform(-40, 40, (M, 2))
            boxes[:, 2] = rng.uniform(-2, 0, M)
            boxes[:, 3:6] = rng.uniform(1, 4, (M, 3))
            boxes[:, 6] = rng.uniform(-np.pi, np.pi, M)
            labels = rng.integers(0, 10, M)
        infos.append(dict(
            token=f"tok{s}",
            timestamp=s * 500000,
            scene_token=(f"scene{s // scene_len}" if scene
                         else "scene0"),
            cams=cams,
            ann_infos=(boxes.tolist(), labels.tolist()),
        ))
    pkl = os.path.join(root, "infos.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"infos": infos, "metadata": {"version": "fake"}}, f)
    return pkl
