"""Faults planted in the program's timed path, to show that `correct`
catches them: the benchmark's tests plant them on the CPU, and
`run.py --fault NAME` (never in a measured run) on the card, to read
each at a cell's own size.

  altered         a served answer altered where it is produced: each
                  detection's size x1.5 after the host NMS;
  half_batch      half of the batch left out: the forward of the first
                  half, its outputs repeated over the whole batch;
  no_suppression  the host NMS suppresses nothing: each task keeps its
                  best-scoring boxes up to the cuts in number;
  labels_shifted  each served detection's class moved to the next one.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

SERVE = ("altered", "half_batch", "no_suppression", "labels_shifted")


def _rows(batch, h):
    B = batch["imgs"].shape[0]
    return {k: v[:h] if torch.is_tensor(v) and v.dim() and v.shape[0] == B
            else v for k, v in batch.items()}


def _best(scores, post_max_size, pre_max_size=None):
    order = np.argsort(-scores)
    return order[:pre_max_size][:post_max_size]


@contextlib.contextmanager
def planted(name: str):
    """Plant fault `name` into the port for a serving run inside the
    block."""
    from ocrfdet_tpu_torch import entry
    from ocrfdet_tpu_torch.models.detector import OcRFDet
    from ocrfdet_tpu_torch.ops import nms
    saved = []

    def patch(obj, attr, new):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)
    served = entry.multi_task_nms
    if name == "altered":
        def altered(*a, **k):
            d = served(*a, **k)
            d = dict(d, boxes=d["boxes"].copy())
            d["boxes"][:, 3:6] *= 1.5
            return d
        patch(entry, "multi_task_nms", altered)
    elif name == "half_batch":
        fwd = OcRFDet.forward

        def half(self, batch):
            B = batch["imgs"].shape[0]
            h = max(B // 2, 1)
            preds, aux = fwd(self, _rows(batch, h))

            def full(t):
                if torch.is_tensor(t) and t.dim() and t.shape[0] == h:
                    return torch.cat([t] * (B // h + 1), 0)[:B]
                return t
            return ([{k: full(v) for k, v in p.items()} for p in preds],
                    {k: full(v) for k, v in aux.items()})
        patch(OcRFDet, "forward", half)
    elif name == "no_suppression":
        patch(nms, "nms_rotated",
              lambda boxes, scores, iou_thr, pre_max_size=None,
              post_max_size=None, native=True:
              _best(scores, post_max_size, pre_max_size))
        patch(nms, "circle_nms",
              lambda centers_scores, radius_thr, post_max_size=83:
              _best(centers_scores[:, 2], post_max_size))
    elif name == "labels_shifted":
        def shifted(task_results, head_cfg, *a, **k):
            d = served(task_results, head_cfg, *a, **k)
            return dict(d, labels=(d["labels"] + 1) % head_cfg.num_classes)
        patch(entry, "multi_task_nms", shifted)
    else:
        raise ValueError(f"no fault {name!r}")
    try:
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)
