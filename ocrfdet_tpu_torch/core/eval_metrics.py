"""Native nuScenes detection metrics (mAP / TP errors / NDS),
devkit-faithful (a copy of ocrfdet_tpu/core/eval_metrics.py).

The reference delegates to the nuScenes devkit
(datasets/nuscenes_dataset.py:432-491); the devkit is not a dependency
of this framework, so the algorithm of the devkit's
`detection/algo.py` (accumulate / calc_ap / calc_tp, config
`detection_cvpr_2019`) is reproduced exactly:

  * class-range filtering of both GT and predictions (car/truck/... 50m,
    pedestrian/cycles 40m, cone/barrier 30m)
  * greedy center-distance matching at {0.5, 1, 2, 4} m, predictions
    sorted by confidence globally per class
  * 101-point recall-interpolated precision;
    AP = mean(clip(prec - 0.1, 0)) / 0.9 over recall in (0.1, 1]
  * TP errors at the 2 m threshold as CUMULATIVE MEANS over the TP
    list, interpolated onto the 101-point confidence grid, averaged
    over recall points in [0.1, max achieved recall]  (calc_tp);
    1.0 when max recall < 0.1
  * per-class metric exclusions: traffic_cone has no orient/vel/attr
    error, barrier no vel/attr; class means are nan-means
  * NDS = (5*mAP + sum_tp max(1 - err, 0)) / 10

Attributes: bevdetv2 info files carry no attribute GT, so GT attributes
are derived from GT (class, velocity) with the same velocity heuristic
the reference applies to predictions (nuscenes_dataset.py:345-431 /
core/nusc_format.py:_attr_for). mAAE is therefore an estimate of the
attribute error rather than the devkit's exact value; pass explicit
`gt_attrs` to `add_sample` when attribute GT is available.

Deviation (documented): classes with zero GT instances are excluded
from the class means instead of contributing AP 0 — on real nuScenes
val every class is present, so this only affects small fixtures.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np

from .nusc_format import _attr_for

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_REC = 101

# devkit detection_cvpr_2019 class_range
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0,
    "motorcycle": 40.0, "bicycle": 40.0, "traffic_cone": 30.0,
    "barrier": 30.0,
}
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err",
              "attr_err")
# devkit evaluate.py: metrics undefined for these (class, metric) pairs
EXCLUDED = {
    ("traffic_cone", "orient_err"), ("traffic_cone", "vel_err"),
    ("traffic_cone", "attr_err"), ("barrier", "vel_err"),
    ("barrier", "attr_err"),
}
METRIC_TO_SUMMARY = dict(trans_err="mATE", scale_err="mASE",
                         orient_err="mAOE", vel_err="mAVE",
                         attr_err="mAAE")


def yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = (a - b) % period
    if d > period / 2:
        d = period - d
    return abs(d)


def aligned_iou_3d(dims_a, dims_b) -> float:
    """3D IoU of translation/yaw-aligned boxes (devkit scale_iou)."""
    inter = np.prod(np.minimum(dims_a, dims_b))
    union = np.prod(dims_a) + np.prod(dims_b) - inter
    return float(inter / max(union, 1e-9))


def cummean(x: np.ndarray) -> np.ndarray:
    """NaN-aware cumulative mean (devkit utils.cummean)."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sum_vals = np.nancumsum(x.astype(float))
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals, out=np.zeros_like(sum_vals),
                     where=count_vals > 0)


class _MetricData:
    """Per (class, dist_th) accumulation result, devkit
    DetectionMetricData: 101-point precision/confidence + TP-error
    curves."""

    def __init__(self, precision, confidence, errs):
        self.precision = precision
        self.confidence = confidence
        self.errs = errs   # {metric: [101] cumulative-mean curve}

    @property
    def max_recall_ind(self) -> int:
        nz = np.nonzero(self.confidence)[0]
        return int(nz[-1]) if len(nz) else -1

    @classmethod
    def no_predictions(cls):
        z = np.zeros(N_REC)
        return cls(z, z, {m: np.ones(N_REC) for m in TP_METRICS})


def calc_ap(md: _MetricData) -> float:
    """devkit algo.calc_ap."""
    prec = md.precision.copy()
    prec = prec[round(100 * MIN_RECALL) + 1:]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def calc_tp(md: _MetricData, metric: str) -> float:
    """devkit algo.calc_tp."""
    first_ind = round(100 * MIN_RECALL) + 1
    last_ind = md.max_recall_ind
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(md.errs[metric][first_ind:last_ind + 1]))


class DetectionEvaluator:
    """Accumulates per-sample predictions + GT; computes mAP/NDS.

    Boxes are [M, 9] (x, y, z_gravity, dx, dy, dz, yaw, vx, vy) in the
    key-ego frame; matching/range use ego-frame xy distance exactly as
    the devkit uses ego-translated global boxes."""

    def __init__(self, class_names: Sequence[str],
                 apply_class_range: bool = True):
        self.class_names = list(class_names)
        self.apply_class_range = apply_class_range
        # per class: list of (score, sample_id, box[9], attr)
        self.preds: Dict[int, list] = defaultdict(list)
        # per (class, sample): list of (gt box[9], attr)
        self.gts: Dict[int, Dict[int, list]] = defaultdict(
            lambda: defaultdict(list))
        self.n_samples = 0
        # sample tokens already scored (duplicate suppression for the
        # padded ragged tail batch, data/dataset.py Loader.epoch)
        self._seen_tokens: set = set()
        self._token_sids: Dict[str, int] = {}

    def __getstate__(self):
        """Plain dicts for pickling (the gather of a multi-process eval):
        the default factories are lambdas."""
        state = dict(self.__dict__)
        state["preds"] = dict(self.preds)
        state["gts"] = {c: dict(v) for c, v in self.gts.items()}
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.preds = defaultdict(list, state["preds"])
        self.gts = defaultdict(lambda: defaultdict(list), {
            c: defaultdict(list, v) for c, v in state["gts"].items()})

    def _in_range(self, box, name) -> bool:
        if not self.apply_class_range:
            return True
        return float(np.hypot(box[0], box[1])) <= CLASS_RANGE.get(
            name, 50.0)

    def add_sample(self, pred_boxes: np.ndarray, scores: np.ndarray,
                   labels: np.ndarray, gt_boxes: np.ndarray,
                   gt_labels: np.ndarray,
                   gt_attrs: Optional[Sequence[str]] = None,
                   token: Optional[str] = None):
        """With `token`, a repeated sample token is silently skipped
        (tail-batch padding duplicates); token-less samples are always
        scored under a fresh integer id."""
        if token is not None:
            if token in self._seen_tokens:
                return
            self._seen_tokens.add(token)
            self._token_sids[token] = self.n_samples
        sid = self.n_samples
        self.n_samples += 1
        for b, s, l in zip(pred_boxes, scores, labels):
            name = self.class_names[int(l)]
            if not self._in_range(b, name):
                continue
            attr = _attr_for(name, np.asarray(b[7:9]))
            self.preds[int(l)].append((float(s), sid, np.asarray(b),
                                       attr))
        for j, (b, l) in enumerate(zip(gt_boxes, gt_labels)):
            name = self.class_names[int(l)]
            if not self._in_range(b, name):
                continue
            attr = (gt_attrs[j] if gt_attrs is not None
                    else _attr_for(name, np.asarray(b[7:9])))
            self.gts[int(l)][sid].append((np.asarray(b), attr))

    def merge(self, other: "DetectionEvaluator"):
        """Fold another evaluator's accumulated samples into this one
        (multi-process eval gather; sample ids are re-based so the
        greedy per-sample matching is unaffected). Token-tracked
        samples present in BOTH shards (a padded tail duplicate that
        landed on another process) are folded only once — the token
        set is merged so later merges stay deduplicated too."""
        off = self.n_samples
        dup = self._seen_tokens & other._seen_tokens
        # which sids belong to duplicate tokens is tracked by the other
        # evaluator at add time
        skip = {sid for tok, sid in other._token_sids.items()
                if tok in dup} if dup else set()
        # COMPACT remap of the other shard's kept sids: n_samples must
        # stay equal to the number of scored samples AND stay above
        # every assigned sid, or a later merge's offset would collide
        # with ids handed out here
        remap = {}
        kept = 0
        for sid in range(other.n_samples):
            if sid not in skip:
                remap[sid] = off + kept
                kept += 1
        for cls, lst in other.preds.items():
            self.preds[cls].extend(
                (s, remap[sid], b, a) for (s, sid, b, a) in lst
                if sid not in skip)
        for cls, per_sample in other.gts.items():
            for sid, lst in per_sample.items():
                if sid not in skip:
                    self.gts[cls][remap[sid]].extend(lst)
        self._seen_tokens |= other._seen_tokens
        for tok, sid in other._token_sids.items():
            if tok not in self._token_sids and sid not in skip:
                self._token_sids[tok] = remap[sid]
        self.n_samples += kept

    # ------------------------------------------------ devkit accumulate
    def accumulate(self, cls: int, dist_th: float) -> Optional[_MetricData]:
        """devkit algo.accumulate for one (class, dist threshold)."""
        npos = sum(len(v) for v in self.gts[cls].values())
        if npos == 0:
            return None
        preds = sorted(self.preds[cls], key=lambda x: -x[0])
        if not preds:
            return _MetricData.no_predictions()
        name = self.class_names[cls]
        period = np.pi if name == "barrier" else 2 * np.pi
        taken: Dict[int, set] = defaultdict(set)
        tp, fp, conf = [], [], []
        match = {m: [] for m in TP_METRICS}
        match_conf = []
        for score, sid, box, attr in preds:
            gts = self.gts[cls].get(sid, [])
            best_d, best_j = np.inf, -1
            for j, (g, _ga) in enumerate(gts):
                if j in taken[sid]:
                    continue
                d = float(np.hypot(box[0] - g[0], box[1] - g[1]))
                if d < best_d:
                    best_d, best_j = d, j
            is_match = best_d < dist_th
            conf.append(score)
            if is_match:
                taken[sid].add(best_j)
                tp.append(1.0)
                fp.append(0.0)
                g, gattr = gts[best_j]
                match["trans_err"].append(best_d)
                match["scale_err"].append(
                    1.0 - aligned_iou_3d(box[3:6], g[3:6]))
                match["orient_err"].append(
                    yaw_diff(box[6], g[6], period))
                match["vel_err"].append(float(np.hypot(
                    box[7] - g[7], box[8] - g[8])))
                match["attr_err"].append(
                    np.nan if gattr == "" else float(attr != gattr))
                match_conf.append(score)
            else:
                tp.append(0.0)
                fp.append(1.0)
        if len(match_conf) == 0:
            return _MetricData.no_predictions()

        tp_c = np.cumsum(tp).astype(float)
        fp_c = np.cumsum(fp).astype(float)
        prec = tp_c / (fp_c + tp_c)
        rec = tp_c / float(npos)
        rec_interp = np.linspace(0, 1, N_REC)
        precision = np.interp(rec_interp, rec, prec, right=0)
        confidence = np.interp(rec_interp, rec, conf, right=0)
        errs = {}
        mc = np.array(match_conf)
        for m in TP_METRICS:
            tmp = cummean(np.array(match[m]))
            # interp needs ascending x; confidences are descending
            errs[m] = np.interp(confidence[::-1], mc[::-1],
                                tmp[::-1])[::-1]
        return _MetricData(precision, confidence, errs)

    # --------------------------------------------------------- summary
    def evaluate(self) -> Dict[str, float]:
        aps: Dict[str, float] = {}
        label_tp: Dict[str, Dict[str, float]] = defaultdict(dict)
        for c, name in enumerate(self.class_names):
            cls_aps, md_tp = [], None
            for d in DIST_THRESHOLDS:
                md = self.accumulate(c, d)
                if md is None:
                    continue
                cls_aps.append(calc_ap(md))
                if d == TP_THRESHOLD:
                    md_tp = md
            if cls_aps:
                aps[name] = float(np.mean(cls_aps))
            if md_tp is not None:
                for m in TP_METRICS:
                    label_tp[name][m] = (np.nan if (name, m) in EXCLUDED
                                         else calc_tp(md_tp, m))
        mAP = float(np.mean(list(aps.values()))) if aps else 0.0

        out = dict(mAP=mAP, per_class_ap=aps)
        tp_scores = []
        for m in TP_METRICS:
            vals = [label_tp[n][m] for n in label_tp]
            err = (float(np.nanmean(vals))
                   if vals and not np.all(np.isnan(vals)) else 1.0)
            out[METRIC_TO_SUMMARY[m]] = err
            tp_scores.append(max(1.0 - err, 0.0))
        out["NDS"] = (5.0 * mAP + sum(tp_scores)) / 10.0
        return out
