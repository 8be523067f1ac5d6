"""bevdetv2 nuScenes info-file reader + temporal frame selection (a
copy of ocrfdet_tpu/data/infos.py, so that the port needs no JAX
package).

Reads the `bevdetv2-nuscenes_infos_{train,val}.pkl` files produced by
the reference's tools/create_data_bevdet.py (:42-150). Each info dict:
  token, lidar_path, sweeps, timestamp, scene_token,
  cams: {CAM_X: {data_path, cam_intrinsic [3,3],
                 sensor2ego_rotation (wxyz) / _translation,
                 ego2global_rotation / _translation, timestamp}},
  ann_infos: (gt_boxes [M, 9] in CAM_FRONT-ego frame, gt_labels [M])
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Sequence

import numpy as np

from ..geometry.quaternion import se3_from_quat

CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)


def load_infos(path: str) -> List[dict]:
    with open(path, "rb") as f:
        data = pickle.load(f)
    infos = data["infos"] if isinstance(data, dict) else data
    # the reference sorts by timestamp inside the dataset class
    return sorted(infos, key=lambda i: i["timestamp"])


def adjacent_infos(infos: List[dict], index: int, num_adj: int,
                   stereo: bool) -> List[dict]:
    """Previous-frame infos for temporal fusion, clamped at scene
    boundaries (nuscenes_dataset.py:280-294). Returns
    [prev_1 .. prev_num_adj (+1 stereo extra)]."""
    info = infos[index]
    out = []
    ids = list(range(1, num_adj + 1))
    if stereo:
        ids.append(num_adj + 1)
    for off in ids:
        sel = max(index - off, 0)
        if infos[sel]["scene_token"] != info["scene_token"]:
            out.append(info)
        else:
            out.append(infos[sel])
    return out


def cam_transforms(cam_info: dict):
    """(sensor2ego [4,4], ego2global [4,4]) for one camera entry."""
    s2e = se3_from_quat(cam_info["sensor2ego_rotation"],
                        cam_info["sensor2ego_translation"])
    e2g = se3_from_quat(cam_info["ego2global_rotation"],
                        cam_info["ego2global_translation"])
    return s2e, e2g


def sensor2keyego(cam_info: dict, key_cam_info: dict) -> np.ndarray:
    """Sweep sensor -> key-frame ego (at the key camera's timestamp):
    inv(keyego2global) @ sweepego2global @ sweepsensor2sweepego
    (loading.py get_sensor2ego_transformation:936-1003)."""
    s2e, e2g = cam_transforms(cam_info)
    _, key_e2g = cam_transforms(key_cam_info)
    return np.linalg.inv(key_e2g) @ e2g @ s2e


def ann_arrays(info: dict) -> tuple:
    """(boxes [M, 9], labels [M]) from ann_infos; bottom-centre z."""
    anns = info.get("ann_infos")
    if anns is None:
        return np.zeros((0, 9), np.float32), np.zeros((0,), np.int64)
    boxes, labels = anns
    boxes = np.asarray(boxes, dtype=np.float32).reshape(-1, 9)
    labels = np.asarray(labels, dtype=np.int64).reshape(-1)
    return boxes, labels


def cbgs_indices(infos: Sequence[dict], num_classes: int = 10,
                 seed: int = 0) -> np.ndarray:
    """Class-balanced resampling indices (CBGSDataset,
    dataset_wrappers.py:8-76): duplicate samples so every class
    contributes ~1/num_classes of the class observations."""
    rng = np.random.default_rng(seed)
    class_sample_idxs: Dict[int, list] = {c: [] for c in range(num_classes)}
    for i, info in enumerate(infos):
        _, labels = ann_arrays(info)
        for c in set(labels.tolist()):
            if 0 <= c < num_classes:
                class_sample_idxs[c].append(i)
    duplicated = sum(len(v) for v in class_sample_idxs.values())
    if duplicated == 0:
        return np.arange(len(infos))
    frac = 1.0 / num_classes
    ratios = [frac / max(len(v) / duplicated, 1e-9)
              for v in class_sample_idxs.values()]
    out = []
    for (c, idxs), ratio in zip(class_sample_idxs.items(), ratios):
        if not idxs:
            continue
        n = int(len(idxs) * ratio)
        out.append(rng.choice(idxs, n).astype(np.int64))
    return np.concatenate(out) if out else np.arange(len(infos))
