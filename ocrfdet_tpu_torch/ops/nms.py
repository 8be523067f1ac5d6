"""BEV NMS (rotated + circle) and the Scale-NMS task merge
(counterpart of ocrfdet_tpu/ops/nms.py and ops/_nms_native.py).

Every request on every device takes one path:

1. `nms_rows` (the custom op `ocrfdet::nms_rows`) builds every task's
   suppression rows of a request after the decode: bit j of row i set
   if box i, kept, suppresses box j (a rotated task's IoU in fp64 after
   the Scale-NMS rescale in fp32 > its threshold; the circle task's
   squared distance in fp32 <= its radius). On the card it is one
   launch of `csrc/nms.cu`; on the CPU the host's pair tests
   (`_host_bits`: the C++ `rotated_iou_matrix`). Both do the arithmetic
   of `csrc/nms.cpp`.
2. `multi_task_nms` hands each task's candidates with its rows to
   `nms_rotated` and `circle_nms`, which run only the greedy scan
   (`csrc/nms.cpp::nms_scan_rows`) in their own `np.argsort` order.

The rows reach those two functions as a view of the candidates
(`_Candidates`, made by `with_rows`) so that their signatures stay the
plain NMS's: the benchmark's planted faults replace them by name with
functions that read the candidates' scores.

`nms_rows_plain` is the kernel's plain version in PyTorch, its oracle
in the tests, and counts its operations (`work=`). `csrc/nms.cpp` (a
copy of the JAX package's native/nms.cpp with the scan added) is
compiled with `c++ -O3 -shared -fPIC` at first use into `build/` at the
root of the checkout (git-ignored; the file name carries a hash of the
source) and loaded with ctypes; if it cannot be built, the call raises.

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
        i64 = ctypes.POINTER(ctypes.c_int64)
        lib.nms_scan_rows.argtypes = [ctypes.c_void_p, ctypes.c_int, i64,
                                      ctypes.c_int, ctypes.c_int, i64]
        lib.nms_scan_rows.restype = ctypes.c_int
        _LIB = lib
        return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def rotated_iou_matrix(boxes_a: np.ndarray,
                       boxes_b: np.ndarray) -> np.ndarray:
    """Exact IoU of rotated BEV rectangles [*,5] (cx, cy, dx, dy, yaw),
    in float64 (`csrc/nms.cpp::rotated_iou_matrix`)."""
    a = np.ascontiguousarray(boxes_a, dtype=np.float64)
    b = np.ascontiguousarray(boxes_b, dtype=np.float64)
    out = np.zeros((len(a), len(b)), dtype=np.float64)
    native_library().rotated_iou_matrix(_dptr(a), len(a), _dptr(b), len(b),
                                        _dptr(out))
    return out


class _Candidates(np.ndarray):
    """A task's candidates that carry the task's suppression rows."""


def with_rows(candidates: np.ndarray, rows: np.ndarray,
              index: np.ndarray) -> np.ndarray:
    """`candidates` (what `nms_rotated` or `circle_nms` takes for a task)
    as a view that carries the task's suppression rows over its decoded
    boxes, `rows` [K, W] uint64 (`nms_rows`), and `index` [N], each
    candidate's row there. Those functions scan the rows; what they read
    of `candidates` is the scores alone."""
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
    return keep[:n]


def nms_rotated(boxes: np.ndarray, scores: np.ndarray, iou_thr: float,
                pre_max_size: int | None = None,
                post_max_size: int | None = None) -> np.ndarray:
    """Greedy rotated NMS of a task's candidates carrying its suppression
    rows (`with_rows`; the rows hold the pair tests at `iou_thr`): the
    scan in `np.argsort(-scores)` order. Returns the kept indices, best
    score first."""
    order = np.argsort(-scores)
    if pre_max_size is not None:
        order = order[:pre_max_size]
    keep = scan_rows(boxes.rows, boxes.index[order],
                     post_max_size or len(order))
    return order[keep]


def circle_nms(centers_scores: np.ndarray, radius_thr: float,
               post_max_size: int = 83) -> np.ndarray:
    """Centre-distance NMS of a task's candidates [N, 3] (x, y, score)
    carrying its suppression rows (`with_rows`; the rows hold the
    squared-distance tests at `radius_thr`): the scan in
    `np.argsort(-score)` order."""
    order = np.argsort(-np.asarray(centers_scores)[:, 2])
    keep = scan_rows(centers_scores.rows, centers_scores.index[order],
                     len(order) if post_max_size is None else post_max_size)
    return order[keep]


def multi_task_nms(task_results: List[Dict[str, np.ndarray]], head_cfg,
                   rows: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
    """Scale-NMS over the decoded tasks of ONE sample, then merge.

    task_results[t]: dict(boxes [K,9], scores [K], labels [K], valid
    [K]) from core.coder.decode_task as numpy (thresholded via
    `valid`); rows[t]: this sample's suppression rows of task t ([K, W]
    uint64 from `nms_rows`, which rescaled and tested the pairs).
    Returns dict(boxes [M,9] with bottom-centre z, scores [M], labels
    [M] global class ids).
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
            count("nms_tasks", 1)
            if head_cfg.nms_type[t] == "circle":
                cands = with_rows(
                    np.concatenate([boxes[:, :2], scores[:, None]], -1),
                    rows[t], np.flatnonzero(m))
                with span("ocrfdet.nms.circle"):
                    keep = circle_nms(cands, head_cfg.circle_nms_min_radius[t],
                                      post_max_size=head_cfg.post_max_size)
            else:
                cands = with_rows(boxes, rows[t], np.flatnonzero(m))
                with span("ocrfdet.nms.rotated"):
                    keep = nms_rotated(
                        cands, scores, head_cfg.nms_thr[t],
                        pre_max_size=head_cfg.pre_max_size,
                        post_max_size=head_cfg.post_max_size)
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


def _host_bits(boxes: np.ndarray, labels: np.ndarray, circle: int,
               thr: float, fac: Sequence[float], nfac: int) -> np.ndarray:
    """The host's pair tests of one task of one sample: boxes [K, 9]
    float32, labels [K], the rest the task's arguments of `nms_rows`.
    The circle task: the squared distance <= thr in fp32. A rotated
    task: the Scale-NMS rescale of dx, dy in fp32 (by fac[0], or by
    fac[c] for a label c below nfac), then the C++ `rotated_iou_matrix`
    > thr. Returns bits [K, K] bool: row i, column j."""
    if circle:
        x, y = boxes[:, 0], boxes[:, 1]
        d2 = (x[:, None] - x[None]) ** 2 + (y[:, None] - y[None]) ** 2
        return d2 <= np.float32(thr)
    f = np.full(len(labels), fac[0] if nfac < 0 else 1.0, np.float32)
    for c in range(max(nfac, 0)):
        f[labels == c] = fac[c]
    bev = np.stack([boxes[:, 0], boxes[:, 1], boxes[:, 3] * f,
                    boxes[:, 4] * f, boxes[:, 6]], 1)
    return rotated_iou_matrix(bev, bev) > thr


# --------------------------------------------- the custom op of nms_rows
@torch.library.custom_op(f"{kernels.OPS_NAMESPACE}::nms_rows",
                         mutates_args=(), device_types="cpu")
def _nms_rows_op(boxes: List[torch.Tensor], labels: List[torch.Tensor],
                 circle: List[int], thr: List[float], fac: List[float],
                 nfac: List[int]) -> torch.Tensor:
    _check_rows_inputs(boxes, labels, circle, thr, fac, nfac)
    B, K = labels[0].shape
    rows = torch.zeros((len(boxes), B, K, -(-K // 64)), dtype=torch.int64)
    for t in range(len(boxes)):
        bx, lab = boxes[t].numpy(), labels[t].numpy()
        f = fac[t * MAX_CLASSES:(t + 1) * MAX_CLASSES]
        for b in range(B):
            rows[t, b] = _pack(torch.from_numpy(_host_bits(
                bx[b], lab[b], circle[t], thr[t], f, nfac[t])))
    return rows


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
    tensors the host's pair tests (`_host_bits`). Returns rows [T, B, K,
    ceil(K/64)] int64: bit j % 64 of word j // 64 of row i set if box i,
    kept, suppresses box j."""
    return _nms_rows_op([d.boxes.contiguous() for d in decoded],
                        [d.labels.contiguous() for d in decoded],
                        *task_params(head_cfg))
