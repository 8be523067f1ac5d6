"""nuScenes submission-format output (devkit-compatible JSON; a copy of
ocrfdet_tpu/core/nusc_format.py).

Re-implements NuScenesDataset._format_bbox (nuscenes_dataset.py:
345-431): detections in the (BDA-free) key-ego frame are transformed to
the global frame using the key CAM_FRONT ego pose, yaw converted to a
global quaternion, and attributes assigned with the velocity/class
heuristic. Anyone with the official devkit can evaluate the resulting
JSON directly; the in-repo native evaluator (eval_metrics.py) consumes
the same boxes pre-transform.
"""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from ..geometry.quaternion import se3_from_quat

DEFAULT_ATTRIBUTES = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}


def _attr_for(name: str, velocity: np.ndarray) -> str:
    if np.linalg.norm(velocity[:2]) > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck",
                    "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
    return DEFAULT_ATTRIBUTES[name]


def _yaw_to_quat(yaw: float) -> List[float]:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def boxes_to_nusc_sample(boxes: np.ndarray, scores: np.ndarray,
                         labels: np.ndarray, class_names,
                         key_cam_front_info: dict,
                         inv_bda: np.ndarray | None = None) -> List[dict]:
    """boxes [M, 9] bottom-centre z in the key-ego frame (post-BDA if
    inv_bda given). Returns the list of nuScenes detection dicts."""
    e2g = se3_from_quat(key_cam_front_info["ego2global_rotation"],
                        key_cam_front_info["ego2global_translation"])
    out = []
    for b, s, l in zip(boxes, scores, labels):
        b = np.asarray(b, dtype=np.float64)
        center = b[:3].copy()
        center[2] += b[5] / 2.0
        yaw = b[6]
        vel = b[7:9].copy()
        if inv_bda is not None:
            center = inv_bda @ center
            vel = (inv_bda[:2, :2] @ vel)
            yaw = yaw  # BDA inverse of yaw handled by caller if needed
        g_center = e2g[:3, :3] @ center + e2g[:3, 3]
        # ego yaw -> global: rotate the heading direction
        h = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        gh = e2g[:3, :3] @ h
        g_yaw = float(np.arctan2(gh[1], gh[0]))
        g_vel = e2g[:3, :3] @ np.array([vel[0], vel[1], 0.0])
        name = class_names[int(l)]
        out.append(dict(
            sample_token=key_cam_front_info.get("sample_token", ""),
            translation=g_center.tolist(),
            size=[float(b[4]), float(b[3]), float(b[5])],  # wlh
            rotation=_yaw_to_quat(g_yaw),
            velocity=[float(g_vel[0]), float(g_vel[1])],
            detection_name=name,
            detection_score=float(s),
            attribute_name=_attr_for(name, g_vel),
        ))
    return out


def write_results_json(results: Dict[str, List[dict]], path: str):
    payload = {
        "meta": {
            "use_camera": True, "use_lidar": False, "use_radar": False,
            "use_map": False, "use_external": False,
        },
        "results": results,
    }
    with open(path, "w") as f:
        json.dump(payload, f)
