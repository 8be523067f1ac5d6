"""The comparisons that decide `correct`: what the timed path produced
against the plain reference on the same inputs and weights, each number
beside its limit (`limits/<workload>.json`).

Serving (per sampled request): the key frame's depth and each of the
heads' maps as its largest gap over the reference's largest magnitude,
a map's magnitude floored at the median map's (random weights can leave
one map all but zero, as one task's velocity at some seeds, and such a
map sets no scale of its own), the worst map's gap (`heads`) and the
median map's (`heads_median`, steady from seed to seed where one map's
tower rounds badly at some weights); every detection served after NMS judged
by what the reference gives at the cell and class it came from (found as
the program's own decoded box nearest to it): the relative L2 gap, over
all served detections, of the score's logit and of each of the 9 box
numbers, a box number's reference norm floored at the median box
number's; an answer with no detection reads infinite. Near-ties in the top-k, the score threshold
and NMS decide which detections near the margins are served, so the
served set is not compared with the reference's own set; instead the
decode and the host NMS are held as a stage of their own: the
reference's decode and NMS (`ref/core/coder.py`, `ref/ops/nms.py`) of
the program's own head maps, which the heads' number holds to the
reference, have to give the served set exactly (`nms`: the detections
in one set and not the other)."""
from __future__ import annotations

import math
import statistics
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from .ref.core.coder import decode_all_tasks
from .ref.ops.nms import multi_task_nms


def rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """max |p - r| / max |r|, both in float64."""
    p, r = p.double(), r.double()
    return float((p - r).abs().max() / r.abs().max().clamp_min(1e-12))


def map_gaps(preds, ref_preds) -> List[float]:
    """Each head map of every task: its largest gap over the larger of
    its own largest magnitude and the median map's."""
    pairs = [(p[k].double(), r[k].double()) for p, r in zip(preds, ref_preds)
             for k in r]
    scales = [float(r.abs().max()) for _, r in pairs]
    floor = statistics.median(scales)
    return [float((p - r).abs().max()) / max(s, floor, 1e-12)
            for (p, r), s in zip(pairs, scales)]


def heads_gap(preds, ref_preds) -> float:
    """The worst head map's gap (`map_gaps`)."""
    return max(map_gaps(preds, ref_preds))


def full_decode(pred: Dict[str, torch.Tensor], head, grid):
    """Every cell's box [B, H*W, 9] (gravity-centred), every class's
    heatmap logit [B, H*W, K] and the length of the (sin, cos) output
    [B, H*W] of one task: the decode's arithmetic without its top-k."""
    B, H, W, K = pred["heatmap"].shape
    dev = pred["heatmap"].device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev),
                            indexing="ij")
    xs, ys = xs.reshape(-1).double(), ys.reshape(-1).double()

    def flat(name):
        v = pred[name].double()
        return v.reshape(B, H * W, v.shape[-1])
    reg, rot = flat("reg"), flat("rot")
    cx = (xs + reg[..., 0]) * head.out_size_factor * head.voxel_size[0] \
        + grid.x[0]
    cy = (ys + reg[..., 1]) * head.out_size_factor * head.voxel_size[1] \
        + grid.y[0]
    boxes = torch.cat([cx[..., None], cy[..., None], flat("height"),
                       torch.exp(flat("dim")),
                       torch.atan2(rot[..., :1], rot[..., 1:2]),
                       flat("vel")], dim=-1)
    return boxes, pred["heatmap"].double().reshape(B, H * W, K), \
        rot.norm(dim=-1)


def _task_dets(d: Dict, offset: int, K: int, device):
    """One sample's detections of one task: gravity-centred boxes,
    scores and task-local labels as tensors."""
    sel = (d["labels"] >= offset) & (d["labels"] < offset + K)
    db = torch.as_tensor(d["boxes"][sel], dtype=torch.float64,
                         device=device).clone().reshape(-1, 9)
    db[:, 2] += 0.5 * db[:, 5]                    # bottom -> gravity centre
    ds = torch.as_tensor(d["scores"][sel], dtype=torch.float64, device=device)
    lab = torch.as_tensor(d["labels"][sel] - offset, device=device).long()
    return db, ds, lab


def _cells(boxes, decoded):
    """The cell whose decoded box centre is nearest each box's."""
    if len(boxes) == 0:
        return torch.zeros(0, dtype=torch.long, device=boxes.device)
    return torch.cdist(boxes[:, :2], decoded[:, :2]).argmin(1)


def detections_gap(dets: List[Dict], preds, ref_preds, head, grid
                   ) -> Dict[str, torch.Tensor]:
    """The served detections of every sample against the reference at
    their cells and classes: per detection, the score's logit, its 9
    box numbers (gravity-centred z; yaw as the wrapped angle times the
    length of the reference's (sin, cos) output, capped at 1, since the
    angle of a near-zero vector means nothing) and the reference's
    values there, as rows [n, 10] of gaps and of reference values."""
    gaps, refs = [], []
    offset = 0
    for t, task in enumerate(head.tasks):
        K = len(task.class_names)
        pb, _, _ = full_decode(preds[t], head, grid)
        rb, rl, rn = full_decode(ref_preds[t], head, grid)
        for b, d in enumerate(dets):
            db, ds, lab = _task_dets(d, offset, K, pb.device)
            if len(db) == 0:
                continue
            cell = _cells(db, pb[b])
            r = rb[b, cell]
            gap = db - r
            dyaw = (db[:, 6] - r[:, 6]).abs() % (2 * math.pi)
            gap[:, 6] = (torch.minimum(dyaw, 2 * math.pi - dyaw)
                         * rn[b, cell].clamp_max(1.0))
            r = r.clone()
            r[:, 6] = math.pi / 2          # the scale of a yaw gap
            ds = ds.clamp(1e-12, 1 - 1e-12)
            logit = torch.log(ds) - torch.log1p(-ds)
            ref_logit = rl[b, cell, lab]
            gaps.append(torch.cat([(logit - ref_logit)[:, None], gap], 1))
            refs.append(torch.cat([ref_logit[:, None], r], 1))
        offset += K
    if not gaps:
        return dict(gaps=torch.zeros(0, 10), refs=torch.zeros(0, 10))
    return dict(gaps=torch.cat(gaps), refs=torch.cat(refs))


def expected_detections(preds, head, grid) -> List[Dict]:
    """The detections that the reference's decode and host NMS give for
    head maps `preds`, one dict per sample (as `entry.infer` serves
    them)."""
    decoded = decode_all_tasks(preds, head, grid)
    host = [{k: v.cpu().numpy() for k, v in d._asdict().items()}
            for d in decoded]
    B = preds[0]["heatmap"].shape[0]
    return [multi_task_nms([{k: v[b] for k, v in d.items()} for d in host],
                           head) for b in range(B)]


def _rows(d: Dict) -> Counter:
    """A sample's detections as a multiset of (label, score, 9 box
    numbers), each number exactly."""
    boxes = np.asarray(d["boxes"], np.float64).reshape(-1, 9).tolist()
    return Counter(zip(np.asarray(d["labels"]).tolist(),
                       np.asarray(d["scores"], np.float64).tolist(),
                       map(tuple, boxes)))


def set_gap(served: List[Dict], expected: List[Dict]) -> int:
    """The detections, over all samples, in one set and not the other."""
    gap = 0
    for s, e in zip(served, expected):
        a, b = _rows(s), _rows(e)
        gap += sum((a - b).values()) + sum((b - a).values())
    return gap


def judge(readings: Dict[str, float], limits: Dict) -> Dict:
    """{name: {"value", "limit"}} for each number, and whether all hold.
    A number that is not finite fails."""
    compared, ok = {}, True
    for name, spec in limits["numbers"].items():
        v = readings.get(name, float("nan"))
        lim = spec["limit"]
        holds = math.isfinite(v) and v <= lim
        ok &= holds
        compared[name] = dict(value=v, limit=lim)
    return dict(correct=bool(ok), compared=compared)


class ServeReadings:
    """The worst of each serving number over the sampled requests."""

    def __init__(self, head, grid):
        self.head, self.grid = head, grid
        self.heads = self.heads_median = self.depth = 0.0
        self.nms = 0
        self.gaps, self.refs = [], []
        self.requests = 0

    def add(self, preds, depth, dets: List[Dict], ref_preds,
            ref_depth) -> None:
        self.requests += 1
        gaps = map_gaps(preds, ref_preds)
        self.heads = max(self.heads, max(gaps))
        self.heads_median = max(self.heads_median, statistics.median(gaps))
        self.depth = max(self.depth, rel_gap(depth, ref_depth))
        self.nms += set_gap(dets, expected_detections(preds, self.head,
                                                      self.grid))
        g = detections_gap(dets, preds, ref_preds, self.head, self.grid)
        self.gaps.append(g["gaps"].cpu())
        self.refs.append(g["refs"].cpu())

    def numbers(self) -> Dict[str, float]:
        """heads and heads_median: the worst and the median map's gap
        (`map_gaps`) of the worst request; depth; nms; det_score and
        det_box: the relative L2 gap
        over every served detection of the score's logit and of the worst
        of the 9 box numbers (each against the larger of its reference's
        norm and the median box number's)."""
        if self.requests == 0:
            return {}
        g, r = torch.cat(self.gaps), torch.cat(self.refs)
        if len(g) == 0:
            rel = torch.full((10,), float("inf"))
        else:
            scale = r.norm(dim=0)
            scale[1:] = scale[1:].clamp_min(float(scale[1:].median()))
            rel = g.norm(dim=0) / scale.clamp_min(1e-12)
        return dict(heads=self.heads, heads_median=self.heads_median,
                    depth=self.depth, nms=float(self.nms),
                    det_score=float(rel[0]), det_box=float(rel[1:].max()))
