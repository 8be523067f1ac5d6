"""SE(3) helpers (numpy; counterpart of
ocrfdet_tpu/geometry/quaternion.py, whose quaternion helpers are not
copied), used by the input generator."""
from __future__ import annotations

import numpy as np


def se3(rot: np.ndarray, trans) -> np.ndarray:
    """4x4 homogeneous transform from 3x3 rotation + 3-translation."""
    m = np.eye(4)
    m[:3, :3] = rot
    m[:3, 3] = np.asarray(trans, dtype=np.float64)
    return m


def yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
