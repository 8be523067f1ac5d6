"""Quaternion and SE(3) helpers (numpy; counterpart of
ocrfdet_tpu/geometry/quaternion.py), used by the host data pipeline and
the nuScenes output format."""
from __future__ import annotations

import numpy as np


def quat_to_matrix(wxyz) -> np.ndarray:
    """Rotation matrix of a (w, x, y, z) quaternion, normalised first
    (pyquaternion's `rotation_matrix`)."""
    w, x, y, z = np.asarray(wxyz, dtype=np.float64)
    n = np.sqrt(w * w + x * x + y * y + z * z)
    if n < 1e-12:
        raise ValueError("zero-norm quaternion")
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def se3(rot: np.ndarray, trans) -> np.ndarray:
    """4x4 homogeneous transform from 3x3 rotation + 3-translation."""
    m = np.eye(4)
    m[:3, :3] = rot
    m[:3, 3] = np.asarray(trans, dtype=np.float64)
    return m


def se3_from_quat(wxyz, trans) -> np.ndarray:
    return se3(quat_to_matrix(wxyz), trans)


def inv_se3(m: np.ndarray) -> np.ndarray:
    """Closed-form inverse of a rigid transform."""
    r = m[:3, :3]
    t = m[:3, 3]
    out = np.eye(4)
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ t
    return out


def yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
