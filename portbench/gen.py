"""The benchmark's input generator: a frozen copy of the port's
`data/synthetic.py::make_batch` (the 6-camera rig and the camera
tensors of a request; its training fields are not copied), with each
sample's ego motion drawn from the seed and the images drawn on the
device.

One input is a whole batch; input `index` of a run with seed `seed`
draws from its own streams, so every input is the same whatever else the
run draws. Per sample, the ego moves `forward_m` (uniform) along its x
axis and turns by `yaw_rad` (uniform) between the key frame and the
adjacent one, and as much again to the stereo reference frame: the plane
sweep of the stereo cost volume and the temporal alignment see that
motion. Images are standard normal (normalised) on the device.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .ref.geometry.quaternion import se3, yaw_matrix


def streams(seed: int, index: int):
    """(numpy generator, device generator seed) of input `index`."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(index)])
    host, dev = ss.spawn(2)
    return (np.random.default_rng(host),
            int(dev.generate_state(1, np.uint64)[0] >> np.uint64(1)))


def camera_rig(num_cams: int, input_size, src_size):
    """(rots [N,3,3] cam->ego, trans [N,3], intrins [N,3,3])."""
    H, W = input_size
    fx = 1266.0 * W / src_size[1]   # nuScenes ~1266 px at 1600 wide
    K = np.array([[fx, 0.0, W / 2.0], [0.0, fx, H / 2.0], [0.0, 0.0, 1.0]])
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


def make_input(cfg, batch: int, seed: int, index: int, device,
               forward_m: Sequence[float], yaw_rad: Sequence[float]) -> Dict:
    """One batch as tensors on `device`, in the port's batch layout:
    imgs [B,F,N,H,W,3], rots/intrins/post_rots [B,F,N,3,3],
    trans/post_trans [B,F,N,3], bda [B,3,3], k2s_sensor [B,F,N,4,4],
    with_prev []."""
    rng, dev_seed = streams(seed, index)
    g = torch.Generator(device=device).manual_seed(dev_seed)
    B, N, F = batch, cfg.data.num_cams, cfg.total_frames
    H, W = cfg.data.input_size
    rots, trans, intrins = camera_rig(N, cfg.data.input_size,
                                      cfg.data.src_size)
    out: Dict[str, np.ndarray] = {}
    out["rots"] = np.broadcast_to(rots, (B, F, N, 3, 3)).astype(np.float32)
    out["trans"] = np.broadcast_to(trans, (B, F, N, 3)).astype(np.float32)
    out["intrins"] = np.broadcast_to(intrins, (B, F, N, 3, 3)).astype(np.float32)
    out["post_rots"] = np.broadcast_to(np.eye(3), (B, F, N, 3, 3)).astype(np.float32)
    out["post_trans"] = np.zeros((B, F, N, 3), dtype=np.float32)
    out["bda"] = np.broadcast_to(np.eye(3), (B, 3, 3)).astype(np.float32)
    dist = rng.uniform(*forward_m, size=B)
    turn = rng.uniform(*yaw_rad, size=B)
    k2s = np.zeros((B, F, N, 4, 4), dtype=np.float32)
    for b in range(B):
        for f in range(F):
            ego = se3(yaw_matrix(f * turn[b]), [f * dist[b], 0.0, 0.0])
            for n in range(N):
                s2e = se3(rots[n], trans[n])
                k2s[b, f, n] = np.linalg.inv(ego @ s2e) @ s2e
    out["k2s_sensor"] = k2s
    out["with_prev"] = np.asarray(1.0, dtype=np.float32)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in out.items()}
    t["imgs"] = torch.randn((B, F, N, H, W, 3), generator=g, device=device)
    return t
