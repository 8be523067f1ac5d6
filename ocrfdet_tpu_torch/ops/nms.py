"""Host-side BEV NMS (rotated + circle) and the Scale-NMS task merge
(counterpart of ocrfdet_tpu/ops/nms.py and ops/_nms_native.py).

The numpy code is the plain version. The rotated IoU and the greedy
rotated NMS also have a C++ path (`csrc/nms.cpp`, a copy of the JAX
package's native/nms.cpp), compiled with `c++ -O3 -shared -fPIC` at
first use into `build/` at the root of the checkout (git-ignored; the
file name carries a hash of the source) and loaded with ctypes. The
C++ path is the default (`native=True`); if it cannot be built, the
call raises: there is no silent fallback to numpy.

Scale-NMS (class-wise box rescaling before NMS, then un-scaling) and
the cross-task merge follow CenterHead.get_task_detections / get_bboxes
of the reference.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..kernels import BUILD_DIR, CSRC

CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    src = CSRC / "nms.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libnms-{h.hexdigest()[:12]}.so"


def native_library():
    """The C++ NMS library, built on first use; raises if it cannot be
    built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            cxx = os.environ.get("CXX") or shutil.which("c++")
            if not cxx:
                raise RuntimeError("NMS library: no C++ compiler (set CXX "
                                   "or put c++ on PATH)")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp,
                                  str(CSRC / "nms.cpp")],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"NMS library build failed:\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        dbl = ctypes.POINTER(ctypes.c_double)
        lib.rotated_iou_matrix.argtypes = [dbl, ctypes.c_int, dbl,
                                           ctypes.c_int, dbl]
        lib.rotated_iou_matrix.restype = None
        lib.nms_rotated.argtypes = [dbl, ctypes.c_int, ctypes.c_double,
                                    ctypes.POINTER(ctypes.c_int64)]
        lib.nms_rotated.restype = ctypes.c_int
        _LIB = lib
        return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


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


def _cross2(u, v) -> float:
    return u[0] * v[1] - u[1] * v[0]


def _poly_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman convex clip of polygon `subject` by `clip`."""
    out = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        edge = b - a
        inp, out = out, []
        if not inp:
            break
        prev = inp[-1]
        prev_in = _cross2(edge, prev - a) >= 0
        for cur in inp:
            cur_in = _cross2(edge, cur - a) >= 0
            if cur_in != prev_in:
                t_den = _cross2(edge, cur - prev)
                if abs(t_den) > 1e-12:
                    t = _cross2(edge, a - prev) / t_den
                    out.append(prev + t * (cur - prev))
            if cur_in:
                out.append(cur)
            prev, prev_in = cur, cur_in
    return np.asarray(out)


def _poly_area(p: np.ndarray) -> float:
    if len(p) < 3:
        return 0.0
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def rotated_iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray,
                       native: bool = True) -> np.ndarray:
    """Exact IoU of rotated BEV rectangles [*,5] (cx, cy, dx, dy, yaw)."""
    if native:
        a = np.ascontiguousarray(boxes_a, dtype=np.float64)
        b = np.ascontiguousarray(boxes_b, dtype=np.float64)
        out = np.zeros((len(a), len(b)), dtype=np.float64)
        native_library().rotated_iou_matrix(_dptr(a), len(a), _dptr(b),
                                            len(b), _dptr(out))
        return out
    ca = _box_corners(boxes_a)
    cb = _box_corners(boxes_b)
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    iou = np.zeros((len(boxes_a), len(boxes_b)))
    for i in range(len(boxes_a)):
        for j in range(len(boxes_b)):
            inter = _poly_area(_poly_clip(ca[i], cb[j]))
            union = area_a[i] + area_b[j] - inter
            if union > 1e-12:
                iou[i, j] = inter / union
    return iou


def nms_rotated(boxes: np.ndarray, scores: np.ndarray, iou_thr: float,
                pre_max_size: int | None = None,
                post_max_size: int | None = None,
                native: bool = True) -> np.ndarray:
    """Greedy rotated NMS; boxes [N, 5] (cx, cy, dx, dy, yaw). Returns
    the kept indices, best score first."""
    order = np.argsort(-scores)
    if pre_max_size is not None:
        order = order[:pre_max_size]
    if native:
        b = np.ascontiguousarray(boxes[order], dtype=np.float64)
        keep_local = np.zeros(len(b), dtype=np.int64)
        n = native_library().nms_rotated(
            _dptr(b), len(b), ctypes.c_double(iou_thr),
            keep_local.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        keep = order[keep_local[:n]]
        return keep[:post_max_size] if post_max_size else keep
    boxes_s = boxes[order]
    iou = rotated_iou_matrix(boxes_s, boxes_s, native=False)
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


def multi_task_nms(task_results: List[Dict[str, np.ndarray]], head_cfg,
                   native: bool = True) -> Dict[str, np.ndarray]:
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
                    post_max_size=head_cfg.post_max_size, native=native)
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
