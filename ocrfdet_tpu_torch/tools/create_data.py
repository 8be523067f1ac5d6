"""Generate bevdetv2-style nuScenes info pickles and point labels
(counterpart of tools_tpu/create_data.py).

The reference's tools/create_data_bevdet.py (GT boxes re-derived in the
key CAM_FRONT ego frame with velocity) and tools/generate_point_label.py
(lidarseg points projected into each camera as sparse [x, y, depth,
class] labels). It needs the nuScenes devkit and the raw dataset; the
devkit is imported only inside the functions, so the rest of the
package does not depend on it. A host tool: it touches no card.

  python -m ocrfdet_tpu_torch.tools.create_data --root data/nuscenes \
      --version v1.0-trainval [--point-labels]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..config import CLASS_NAMES

# nuScenes general category -> detection class (reference
# create_data_bevdet.py map_name_from_general_to_detection)
NAME_MAP = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

CAMS = ("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
        "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT")


def sample_info(nusc, sample) -> dict:
    from pyquaternion import Quaternion
    from nuscenes.utils.data_classes import Box

    cams = {}
    for cam in CAMS:
        sd = nusc.get("sample_data", sample["data"][cam])
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        cams[cam] = dict(
            data_path=nusc.get_sample_data_path(sample["data"][cam]),
            cam_intrinsic=cs["camera_intrinsic"],
            sensor2ego_rotation=cs["rotation"],
            sensor2ego_translation=cs["translation"],
            ego2global_rotation=pose["rotation"],
            ego2global_translation=pose["translation"],
            timestamp=sd["timestamp"],
        )

    # GT in the CAM_FRONT ego frame with velocities
    # (reference create_data_bevdet.py get_gt:42-83)
    front = cams["CAM_FRONT"]
    trans = -np.array(front["ego2global_translation"])
    rot_inv = Quaternion(front["ego2global_rotation"]).inverse
    boxes, labels = [], []
    for tok in sample["anns"]:
        ann = nusc.get("sample_annotation", tok)
        name = NAME_MAP.get(ann["category_name"])
        if name is None or (ann["num_lidar_pts"]
                            + ann["num_radar_pts"]) <= 0:
            continue
        box = Box(ann["translation"], ann["size"],
                  Quaternion(ann["rotation"]),
                  velocity=tuple(nusc.box_velocity(tok)))
        box.translate(trans)
        box.rotate(rot_inv)
        dxdydz = np.array(box.wlh)[[1, 0, 2]]
        yaw = box.orientation.yaw_pitch_roll[0]
        vel = np.nan_to_num(np.array(box.velocity[:2]))
        boxes.append(np.concatenate(
            [box.center, dxdydz, [yaw], vel]).astype(np.float32))
        labels.append(CLASS_NAMES.index(name))
    return dict(
        token=sample["token"],
        timestamp=sample["timestamp"],
        scene_token=sample["scene_token"],
        cams=cams,
        ann_infos=(np.asarray(boxes, np.float32).reshape(-1, 9).tolist(),
                   labels),
    )


def generate_point_labels(nusc, sample, out_root: str):
    """Project lidarseg points into each camera; save [4, K] arrays of
    (x, y, depth, class) per image (reference
    tools/generate_point_label.py:42-111; class -1 = background)."""
    from nuscenes.utils.data_classes import LidarPointCloud
    from pyquaternion import Quaternion

    sd_lidar = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
    pc = LidarPointCloud.from_file(
        nusc.get_sample_data_path(sample["data"]["LIDAR_TOP"]))
    seg_path = os.path.join(
        nusc.dataroot, nusc.get("lidarseg", sd_lidar["token"])["filename"])
    seg = np.fromfile(seg_path, dtype=np.uint8)
    # lidarseg ids of the 10 fg detection classes (devkit category ids)
    fg = {2, 3, 4, 5, 6, 7, 9, 10, 12, 14, 15, 16, 17, 18, 21, 22, 23}
    cls = np.where(np.isin(seg, list(fg)), seg.astype(np.int16), -1)

    cs_l = nusc.get("calibrated_sensor", sd_lidar["calibrated_sensor_token"])
    pose_l = nusc.get("ego_pose", sd_lidar["ego_pose_token"])
    pc.rotate(Quaternion(cs_l["rotation"]).rotation_matrix)
    pc.translate(np.array(cs_l["translation"]))
    pc.rotate(Quaternion(pose_l["rotation"]).rotation_matrix)
    pc.translate(np.array(pose_l["translation"]))

    for cam in CAMS:
        sd = nusc.get("sample_data", sample["data"][cam])
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        pts = pc.points[:3].copy()
        pts = pts - np.array(pose["translation"])[:, None]
        pts = Quaternion(pose["rotation"]).inverse.rotation_matrix @ pts
        pts = pts - np.array(cs["translation"])[:, None]
        pts = Quaternion(cs["rotation"]).inverse.rotation_matrix @ pts
        depth = pts[2]
        K = np.asarray(cs["camera_intrinsic"])
        uv = K @ pts
        uv = uv[:2] / np.maximum(uv[2], 1e-6)
        ok = (depth > 1.0) & (uv[0] >= 0) & (uv[0] < 1600) \
            & (uv[1] >= 0) & (uv[1] < 900)
        out = np.stack([uv[0][ok], uv[1][ok], depth[ok],
                        cls[ok].astype(np.float64)])
        rel = nusc.get_sample_data_path(sample["data"][cam])
        dst = rel.replace("samples/", "samples_point_label/")
        dst = dst.rsplit(".", 1)[0] + ".npy"
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        np.save(dst, out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--point-labels", action="store_true")
    args = ap.parse_args(argv)

    from nuscenes.nuscenes import NuScenes
    from nuscenes.utils import splits

    nusc = NuScenes(version=args.version, dataroot=args.root,
                    verbose=True)
    scene_splits = {
        "v1.0-trainval": (splits.train, splits.val),
        "v1.0-mini": (splits.mini_train, splits.mini_val),
    }[args.version]
    name_by_scene = {s["token"]: s["name"] for s in nusc.scene}

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        info = sample_info(nusc, sample)
        scene_name = name_by_scene[sample["scene_token"]]
        (train_infos if scene_name in scene_splits[0]
         else val_infos).append(info)
        if args.point_labels:
            generate_point_labels(nusc, sample, args.root)
    for split, infos in (("train", train_infos), ("val", val_infos)):
        path = os.path.join(args.root,
                            f"bevdetv2-nuscenes_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"infos": infos,
                         "metadata": {"version": args.version}}, f)
        print(f"wrote {len(infos)} infos -> {path}")


if __name__ == "__main__":
    main()
