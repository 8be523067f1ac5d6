"""BEV NMS (rotated + circle) and the Scale-NMS task merge
(counterpart of ocrfdet_tpu/ops/nms.py and ops/_nms_native.py).

The numpy code is the plain version. The rotated IoU and the greedy
rotated NMS also have a C++ path (`csrc/nms.cpp`, a copy of the JAX
package's native/nms.cpp), compiled with `c++ -O3 -shared -fPIC` at
first use into `build/` at the root of the checkout (git-ignored; the
file name carries a hash of the source) and loaded with ctypes. The
C++ path is the default (`native=True`); if it cannot be built, the
call raises: there is no silent fallback to numpy.

On the card the pair tests move to the device: `nms_rows` (the custom
op `ocrfdet::nms_rows`, kernel `csrc/nms.cu`) builds every task's
suppression rows of a request in one launch after the decode, bit j of
row i set if box i, kept, suppresses box j (the rotated tasks' IoU in
fp64 after the Scale-NMS rescale in fp32, the circle task's distance in
fp32: the arithmetic of the host paths). `multi_task_nms` given those
rows hands each task's candidates to `nms_rotated` and `circle_nms`
carrying them (`with_rows`), and those run only the greedy scan
(`csrc/nms.cpp::nms_scan_rows`) in their own `np.argsort` order, so the
kept set is the host path's. Its plain version, `nms_rows_plain`, runs
for CPU tensors; `entry.infer` asks for rows only when the decoded
boxes are on the card.

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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..kernels import BUILD_DIR, CSRC
from ..utils.spans import count, span

CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_LIB = None
_LOCK = threading.Lock()

ROWS_KERNEL = kernels.Kernel(
    name="nms_rows", source="nms.cu", symbol="nms_rows",
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 2,
    replaces="none (the JAX package's NMS ran on the host: native/nms.cpp)")
MAX_TASKS = 16      # tasks a launch takes
MAX_CLASSES = 8     # Scale-NMS factors a task may hold
CLIP_VERTICES = 19  # the most a clipped polygon reaches (csrc/nms.cu)


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
        i64 = ctypes.POINTER(ctypes.c_int64)
        lib.nms_scan_rows.argtypes = [ctypes.c_void_p, ctypes.c_int, i64,
                                      ctypes.c_int, ctypes.c_int, i64]
        lib.nms_scan_rows.restype = ctypes.c_int
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


class _Candidates(np.ndarray):
    """A task's candidates that carry the card's suppression rows."""


def with_rows(candidates: np.ndarray, rows: np.ndarray,
              index: np.ndarray) -> np.ndarray:
    """`candidates` (what `nms_rotated` or `circle_nms` takes for a task)
    as a view that carries the task's suppression rows over its decoded
    boxes, `rows` [K, W] uint64 (`nms_rows`), and `index` [N], each
    candidate's row there. Those functions then scan the rows and test
    no pair; what they read of `candidates` is the scores alone."""
    c = np.asarray(candidates).view(_Candidates)
    c.rows, c.index = rows, np.asarray(index, dtype=np.int64)
    return c


def scan_rows(rows: np.ndarray, order: np.ndarray,
              max_keep: int) -> np.ndarray:
    """The greedy scan (`csrc/nms.cpp::nms_scan_rows`) over suppression
    rows [K, W] uint64 of the candidates `order` (their rows, best score
    first): the positions in `order` of the kept ones, at most
    `max_keep`."""
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    K, W = rows.shape
    if K > 64 * W:
        raise ValueError(f"scan_rows: {K} rows of {W} words")
    if len(order) and (order.min() < 0 or order.max() >= K):
        raise ValueError(f"scan_rows: a candidate's row outside [0, {K})")
    keep = np.zeros(max(min(len(order), max_keep), 0), dtype=np.int64)
    i64 = ctypes.POINTER(ctypes.c_int64)
    n = native_library().nms_scan_rows(
        rows.ctypes.data_as(ctypes.c_void_p), W,
        order.ctypes.data_as(i64), len(order), len(keep),
        keep.ctypes.data_as(i64))
    count("nms_rows_tasks", 1)
    return keep[:n]


def nms_rotated(boxes: np.ndarray, scores: np.ndarray, iou_thr: float,
                pre_max_size: int | None = None,
                post_max_size: int | None = None,
                native: bool = True) -> np.ndarray:
    """Greedy rotated NMS; boxes [N, 5] (cx, cy, dx, dy, yaw), or a
    task's candidates carrying the card's suppression rows
    (`with_rows`), which are scanned instead of testing pairs. Returns
    the kept indices, best score first."""
    order = np.argsort(-scores)
    if pre_max_size is not None:
        order = order[:pre_max_size]
    if isinstance(boxes, _Candidates):
        keep = scan_rows(boxes.rows, boxes.index[order],
                         post_max_size or len(order))
        return order[keep]
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
    threshold as in the reference. Candidates carrying the card's
    suppression rows (`with_rows`) are scanned instead."""
    if isinstance(centers_scores, _Candidates):
        scores = np.asarray(centers_scores)[:, 2]
        order = np.argsort(-scores)
        keep = scan_rows(centers_scores.rows, centers_scores.index[order],
                         len(order) if post_max_size is None
                         else post_max_size)
        return order[keep]
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


def scale_nms_bev(boxes: np.ndarray, labels: np.ndarray,
                  factor) -> np.ndarray:
    """A rotated task's decoded boxes [N, 9] after the Scale-NMS rescale
    of dx, dy, dz by `factor` (one, or one a class), as the pair tests
    take them: [N, 5] (cx, cy, dx, dy, yaw)."""
    scaled = boxes.copy()
    if isinstance(factor, (tuple, list)):
        for cid, f in enumerate(factor):
            scaled[labels == cid, 3:6] *= f
    else:
        scaled[:, 3:6] *= factor
    return scaled[:, [0, 1, 3, 4, 6]]


def pair_test_rows(boxes: np.ndarray, labels: np.ndarray, head_cfg,
                   t: int) -> np.ndarray:
    """Task t's suppression rows over one sample's decoded boxes [K, 9]
    float32 and labels [K], from the host's pair tests: the C++
    `rotated_iou_matrix` after `scale_nms_bev`, or `circle_nms`'s float32
    distance. [K, ceil(K/64)] uint64, what `nms_rows` builds on the
    card."""
    if head_cfg.nms_type[t] == "circle":
        x, y = boxes[:, 0], boxes[:, 1]
        d2 = (x[:, None] - x[None]) ** 2 + (y[:, None] - y[None]) ** 2
        bits = d2 <= head_cfg.circle_nms_min_radius[t]
    else:
        bev = scale_nms_bev(boxes, labels, head_cfg.nms_rescale_factor[t])
        bits = rotated_iou_matrix(bev, bev) > head_cfg.nms_thr[t]
    return _pack(torch.from_numpy(bits)).numpy().view(np.uint64)


def multi_task_nms(task_results: List[Dict[str, np.ndarray]], head_cfg,
                   native: bool = True,
                   rows: Optional[Sequence[np.ndarray]] = None
                   ) -> Dict[str, np.ndarray]:
    """Scale-NMS over the decoded tasks of ONE sample, then merge.

    task_results[t]: dict(boxes [K,9], scores [K], labels [K], valid
    [K]) from core.coder.decode_task as numpy (thresholded via
    `valid`). rows: None (the host tests the pairs), or per task this
    sample's suppression rows ([K, W] uint64 from `nms_rows`). Returns
    dict(boxes [M,9] with bottom-centre z, scores [M], labels [M] global
    class ids).
    """
    merged_boxes, merged_scores, merged_labels = [], [], []
    class_offset = 0
    for t, res in enumerate(task_results):
        m = res["valid"].astype(bool)
        boxes = res["boxes"][m].copy()
        scores = res["scores"][m]
        labels = res["labels"][m]
        n_cls = len(head_cfg.tasks[t].class_names)
        task_rows = rows[t] if rows is not None else None
        if len(boxes):
            count("nms_tasks", 1)
            if head_cfg.nms_type[t] == "circle":
                radius = head_cfg.circle_nms_min_radius[t]
                cands = np.concatenate([boxes[:, :2], scores[:, None]], -1)
                if task_rows is not None:
                    cands = with_rows(cands, task_rows, np.flatnonzero(m))
                with span("ocrfdet.nms.circle"):
                    keep = circle_nms(cands, radius,
                                      post_max_size=head_cfg.post_max_size)
            else:
                if task_rows is not None:   # rescaled and tested on the card
                    bev = with_rows(boxes, task_rows, np.flatnonzero(m))
                else:
                    bev = scale_nms_bev(boxes, labels,
                                        head_cfg.nms_rescale_factor[t])
                with span("ocrfdet.nms.rotated"):
                    keep = nms_rotated(
                        bev, scores, head_cfg.nms_thr[t],
                        pre_max_size=head_cfg.pre_max_size,
                        post_max_size=head_cfg.post_max_size, native=native)
            count("nms_candidates", len(boxes))
            count("nms_kept", len(keep))
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


# ------------------------------------- the pair tests as suppression rows
def task_params(head_cfg) -> Tuple[List[int], List[float], List[float],
                                    List[int]]:
    """What `nms_rows` takes of each task of `head_cfg`: circle (1 for
    the circle NMS), thr (the IoU threshold, or the circle's radius), fac
    (MAX_CLASSES Scale-NMS factors a task) and nfac (how many of them are
    the classes' own; -1 where one factor serves every class)."""
    circle, thr, fac, nfac = [], [], [], []
    for t in range(len(head_cfg.tasks)):
        is_circle = head_cfg.nms_type[t] == "circle"
        f = head_cfg.nms_rescale_factor[t]
        if is_circle:                 # the circle NMS does not rescale
            row, n = [], 0
        elif isinstance(f, (tuple, list)):
            row, n = [float(x) for x in f], len(f)
        else:
            row, n = [float(f)], -1
        if len(row) > MAX_CLASSES:
            raise ValueError(f"nms_rows: task {t} has {len(row)} Scale-NMS "
                             f"factors, at most {MAX_CLASSES}")
        circle.append(int(is_circle))
        thr.append(float(head_cfg.circle_nms_min_radius[t] if is_circle
                         else head_cfg.nms_thr[t]))
        fac += row + [1.0] * (MAX_CLASSES - len(row))
        nfac.append(n)
    return circle, thr, fac, nfac


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """[..., K] bool -> [..., ceil(K/64)] int64, bit j % 64 of word j //
    64 (the bits of a uint64 row)."""
    K = bits.shape[-1]
    W = -(-K // 64)
    b = F.pad(bits, (0, W * 64 - K)).reshape(*bits.shape[:-1], W, 64)
    return (b.long() << torch.arange(64, device=bits.device)).sum(-1)


def _tally(work, key, n) -> None:
    if work is not None:
        work[key] = work.get(key, 0) + int(n)


def _clip_area(sx, sy, cx, cy, work=None):
    """`csrc/nms.cu::inter_area` over P pairs at once: subject corners
    sx, sy [P, 4] clipped by the clip corners cx, cy [P, 4] in fp64, each
    operation rounded as there. Returns area [P]. With `work`, adds to
    work["fp64"] the fp64 operations the kernel's code does for these
    pairs, counted where it branches."""
    P = sx.shape[0]
    X = sx.new_zeros((P, CLIP_VERTICES))
    Y = sx.new_zeros((P, CLIP_VERTICES))
    X[:, :4], Y[:, :4] = sx, sy
    n = torch.full((P,), 4, dtype=torch.long)
    pairs = torch.arange(P)

    def put(A, at, ok, v):       # lanes not ok write back what is there
        at = at.clamp(max=CLIP_VERTICES - 1)[:, None]
        A.scatter_(1, at, torch.where(ok, v, A.gather(1, at)[:, 0])[:, None])

    for i in range(4):
        e0x, e0y = cx[:, i], cy[:, i]
        ex, ey = cx[:, (i + 1) % 4] - e0x, cy[:, (i + 1) % 4] - e0y

        def inside(px, py):
            return ex * (py - e0y) - ey * (px - e0x) >= 0.0
        # a pass: ex, ey and the last vertex's cross (7)
        _tally(work, "fp64", 9 * (n > 0).sum())
        last = (n - 1).clamp(min=0)
        px, py = X[pairs, last], Y[pairs, last]
        p_in = inside(px, py)
        OX, OY = torch.zeros_like(X), torch.zeros_like(Y)
        m = torch.zeros_like(n)
        for k in range(int(n.max()) if P else 0):
            act = k < n
            qx, qy = X[:, k], Y[:, k]
            q_in = inside(qx, qy)
            dx, dy = qx - px, qy - py
            den = ex * dy - ey * dx
            cross = act & (q_in != p_in)
            cut = cross & (den.abs() > 1e-12)
            t = (ex * (e0y - py) - ey * (e0x - px)) / den
            # a vertex's cross (7); a crossing's dx, dy, den (5); a cut's
            # t (6) and its point (4)
            _tally(work, "fp64", 7 * act.sum() + 5 * cross.sum()
                   + 10 * cut.sum())
            for ok, vx, vy in ((cut, px + t * dx, py + t * dy),
                               (act & q_in, qx, qy)):
                put(OX, m, ok, vx)
                put(OY, m, ok, vy)
                m = m + ok.long()
            px, py = torch.where(act, qx, px), torch.where(act, qy, py)
            p_in = torch.where(act, q_in, p_in)
        X, Y, n = OX, OY, m
    s = sx.new_zeros(P)
    for k in range(int(n.max()) if P else 0):
        act = k < n
        nxt = torch.where(n == k + 1, 0, k + 1).clamp(max=CLIP_VERTICES - 1)
        term = X[:, k] * Y[pairs, nxt] - X[pairs, nxt] * Y[:, k]
        s = torch.where(act, s + term, s)
    # the shoelace: 4 a vertex, and the halving
    _tally(work, "fp64", (4 * n + 1)[n >= 3].sum())
    return torch.where(n >= 3, s.abs() * 0.5, 0.0)


def _rotated_bits(boxes, labels, thr: float, fac: Sequence[float],
                  nfac: int, work=None):
    """One rotated task of one sample: boxes [K, 9] f32, labels [K]. The
    Scale-NMS rescale in fp32, then `pair_iou(box_i, box_j) > thr` in
    fp64 for every (i, j) as `csrc/nms.cu` computes it. Returns bits
    [K, K] bool; with `work`, counts the kernel's operations as
    `nms_rows_plain` says."""
    table = torch.tensor(list(fac) + [1.0], dtype=torch.float32)
    if nfac < 0:
        f = table[0].expand(labels.shape)
        scaled = torch.ones_like(labels, dtype=torch.bool)
    else:
        scaled = (labels >= 0) & (labels < nfac)
        f = table[torch.where(scaled, labels, MAX_CLASSES)]
    dxy = boxes[:, 3:5] * f[:, None]
    b = torch.stack([boxes[:, 0], boxes[:, 1], dxy[:, 0], dxy[:, 1],
                     boxes[:, 6]], 1).double()
    cx, cy, dx, dy, yaw = b.unbind(1)
    r = 0.5 * torch.sqrt(dx * dx + dy * dy)
    area = dx * dy
    c, s = torch.cos(yaw), torch.sin(yaw)
    hx, hy = dx * 0.5, dy * 0.5
    lx = torch.stack([hx, -hx, -hx, hx], 1)
    ly = torch.stack([hy, hy, -hy, -hy], 1)
    px = cx[:, None] + c[:, None] * lx - s[:, None] * ly
    py = cy[:, None] + s[:, None] * lx + c[:, None] * ly
    ex = cx[:, None] - cx[None, :]
    ey = cy[:, None] - cy[None, :]
    rr = r[:, None] + r[None, :]
    near = ~(ex * ex + ey * ey > rr * rr)
    iou = torch.zeros(near.shape, dtype=torch.float64)
    i, j = near.nonzero(as_tuple=True)
    inter = _clip_area(px[i], py[i], px[j], py[j], work)
    uni = area[i] + area[j] - inter
    iou[i, j] = torch.where(uni > 1e-12, inter / uni, 0.0)
    K = len(labels)
    # make_rbox a box: the rescale (2 fp32) and radius, area, halves and
    # corners (40 fp64, sincos not counted); rotated_bit a pair: the
    # distance test (7), and for a near pair the union and the quotient
    _tally(work, "fp32", 2 * scaled.sum())
    _tally(work, "fp64", 40 * K + 7 * K * K + 2 * len(i)
           + (uni > 1e-12).sum())
    _tally(work, "near_pairs", len(i))
    return iou > thr


def nms_rows_plain(boxes: Sequence[torch.Tensor],
                   labels: Sequence[torch.Tensor], circle: Sequence[int],
                   thr: Sequence[float], fac: Sequence[float],
                   nfac: Sequence[int],
                   work: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """Plain version of the `nms_rows` kernel (`csrc/nms.cu`), on the
    CPU. boxes[t] [B, K, 9] f32 and labels[t] [B, K] of each task; the
    rest as `task_params` gives them. Returns rows [T, B, K, ceil(K/64)]
    int64: bit j % 64 of word j // 64 of row i set if box i, kept,
    suppresses box j. The fp32 and fp64 operations are the kernel's, one
    by one, rounded alike; the fp64 cos and sin may differ in their last
    bit. With `work`, adds to work["fp32"] and work["fp64"] the
    arithmetic operations (add, sub, mul, div, sqrt) the kernel's code
    does for these boxes, each box's set-up counted once, and to
    work["near_pairs"] the pairs it clips."""
    T = len(boxes)
    B, K = labels[0].shape
    rows = torch.zeros((T, B, K, -(-K // 64)), dtype=torch.int64)
    for t in range(T):
        bx = boxes[t].float()
        for b in range(B):
            if circle[t]:
                x, y = bx[b, :, 0], bx[b, :, 1]
                dx = x[:, None] - x[None, :]
                dy = y[:, None] - y[None, :]
                bits = dx * dx + dy * dy <= torch.tensor(
                    thr[t], dtype=torch.float32)
                _tally(work, "fp32", 5 * K * K)   # circle_bit
            else:
                bits = _rotated_bits(
                    bx[b], labels[t][b],
                    thr[t], fac[t * MAX_CLASSES:(t + 1) * MAX_CLASSES],
                    nfac[t], work)
            rows[t, b] = _pack(bits)
    return rows


def _check_rows_inputs(boxes, labels, circle, thr, fac, nfac):
    T = len(boxes)
    if not 0 < T <= MAX_TASKS:
        raise ValueError(f"nms_rows: {T} tasks, at most {MAX_TASKS}")
    if not (len(labels) == len(circle) == len(thr) == len(nfac) == T
            and len(fac) == T * MAX_CLASSES):
        raise ValueError("nms_rows: one boxes, labels, circle, thr and nfac "
                         f"a task and {MAX_CLASSES} factors a task expected")
    B, K = labels[0].shape
    if B * T > 65535:
        raise ValueError(f"nms_rows: {T} tasks x {B} samples, at most 65535")
    for t in range(T):
        if tuple(boxes[t].shape) != (B, K, 9) or \
                tuple(labels[t].shape) != (B, K):
            raise ValueError(f"nms_rows: task {t}: boxes "
                             f"{tuple(boxes[t].shape)}, labels "
                             f"{tuple(labels[t].shape)}, expected "
                             f"{(B, K, 9)} and {(B, K)}")
        if boxes[t].dtype != torch.float32 or labels[t].dtype != torch.int64:
            raise TypeError(f"nms_rows: task {t}: boxes float32 and labels "
                            f"int64 expected, got {boxes[t].dtype} and "
                            f"{labels[t].dtype}")
        if boxes[t].device != labels[0].device or \
                labels[t].device != labels[0].device:
            raise ValueError(f"nms_rows: task {t} on another device")
        if not (boxes[t].is_contiguous() and labels[t].is_contiguous()):
            raise ValueError(f"nms_rows: task {t} is not contiguous")
        if nfac[t] > MAX_CLASSES:
            raise ValueError(f"nms_rows: task {t}: {nfac[t]} factors")


# --------------------------------------------- the custom op of nms_rows
@torch.library.custom_op(f"{kernels.OPS_NAMESPACE}::nms_rows",
                         mutates_args=(), device_types="cpu")
def _nms_rows_op(boxes: List[torch.Tensor], labels: List[torch.Tensor],
                 circle: List[int], thr: List[float], fac: List[float],
                 nfac: List[int]) -> torch.Tensor:
    return nms_rows_plain(boxes, labels, circle, thr, fac, nfac)


@_nms_rows_op.register_kernel("cuda")
def _(boxes, labels, circle, thr, fac, nfac):
    _check_rows_inputs(boxes, labels, circle, thr, fac, nfac)
    T = len(boxes)
    B, K = labels[0].shape
    dev = labels[0].device
    rows = torch.empty((T, B, K, -(-K // 64)), dtype=torch.int64,
                       device=dev)
    ptrs = ctypes.c_void_p * T
    ROWS_KERNEL.launch(
        ptrs(*[b.data_ptr() for b in boxes]),
        ptrs(*[lab.data_ptr() for lab in labels]),
        (ctypes.c_int * T)(*circle), (ctypes.c_double * T)(*thr),
        (ctypes.c_float * (T * MAX_CLASSES))(*fac),
        (ctypes.c_int * T)(*nfac), T, B, K, kernels.ptr(rows),
        kernels.stream_of(rows))
    return rows


@_nms_rows_op.register_fake
def _(boxes, labels, circle, thr, fac, nfac):
    B, K = labels[0].shape
    return labels[0].new_empty((len(boxes), B, K, (K + 63) // 64))


def nms_rows(decoded, head_cfg):
    """The suppression rows of every task and sample of a request
    (`ocrfdet::nms_rows`): decoded, `core.coder.decode_all_tasks`'s
    boxes per task. On CUDA tensors one launch of `csrc/nms.cu`, on CPU
    tensors `nms_rows_plain`. Returns rows [T, B, K, ceil(K/64)] int64,
    as `nms_rows_plain`."""
    return _nms_rows_op([d.boxes.contiguous() for d in decoded],
                        [d.labels.contiguous() for d in decoded],
                        *task_params(head_cfg))
