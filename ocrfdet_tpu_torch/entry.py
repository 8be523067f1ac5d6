"""Entry points of the port (counterpart of `__graft_entry__.entry()`
and of the JAX package's single-device train step).

    model = build_detector(cfg)                  # on "cuda" by default
    batch = make_batch(cfg, seed=0)
    preds, aux, decoded, detections = infer(model, batch)   # one request

    state = build_trainer(cfg)                   # train mode, AdamW, EMA
    batch = make_batch(cfg, seed=0, batch_size=2, with_targets=True)
    metrics = train_step(state, batch)           # losses, skipped_nonfinite

The default config is the flagship `ocrfdet_config(batch_size=1)`, with
the OcRF branch and HOA on; `with_ocrf=False` selects the BEVDepth-style
LSS slice, `ocrfdet_8f_config()` the 8-frame variant and
`geoenh_config()` GeoEnhDet (a config with `vggt_teacher` builds
`GeoEnhDet`, whose frozen VGGT teacher has seeded random weights unless
a trainer loads the released checkpoint). `entry()` returns the flagship
eval forward and its example batch, as the JAX package's
`__graft_entry__.entry()` does. Everything
runs on the card unless the caller passes `device="cpu"`; without CUDA
the default device raises.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, Optional

import numpy as np
import torch

from .config import OcRFDetConfig, ocrfdet_config
from .core.coder import decode_all_tasks
from .data import synthetic
from .models.detector import OcRFDet
from .models.geoenh import GeoEnhDet
from .ops.nms import multi_task_nms, nms_rows
from .train.step import TrainState, train_step  # noqa: F401 (entry point)
from .utils import spans
from .utils.weights import init_weights


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda", which must be available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return device


def detector_class(cfg: OcRFDetConfig):
    """`GeoEnhDet` where the config has a VGGT teacher, else `OcRFDet`."""
    return OcRFDet if cfg.vggt_teacher is None else GeoEnhDet


def build_detector(cfg: Optional[OcRFDetConfig] = None, device=None,
                   seed: int = 0) -> OcRFDet:
    """The eval-mode detector with seeded random weights on `device`."""
    device = resolve_device(device)
    cfg = cfg or ocrfdet_config(batch_size=1)
    model = init_weights(detector_class(cfg)(cfg), seed)
    return model.eval().to(device)


def build_trainer(cfg: Optional[OcRFDetConfig] = None, device=None,
                  seed: int = 0, steps_per_epoch: int = 100) -> TrainState:
    """The training state of `cfg` (default the flagship
    `ocrfdet_config()`, batch from the batches given to `train_step`):
    the model with its render heads and seeded random weights in train
    mode on `device`, AdamW state, EMA, step 0."""
    device = resolve_device(device)
    cfg = cfg or ocrfdet_config()
    model = init_weights(detector_class(cfg)(cfg, render_heads=True),
                         seed).to(device)
    return TrainState(cfg, model, steps_per_epoch=steps_per_epoch, seed=seed)


def make_batch(cfg: OcRFDetConfig, seed: int = 0, batch_size: int = 1,
               device=None, with_targets: bool = False) -> Dict:
    """A synthetic request as tensors on `device`; with `with_targets`
    a training batch (the per-task targets as lists of tensors)."""
    device = resolve_device(device)
    return to_device(synthetic.make_batch(cfg, batch_size=batch_size,
                                          seed=seed,
                                          with_targets=with_targets), device)


def to_device(arrays: Dict, device) -> Dict:
    """numpy arrays (and lists of them, as the per-task targets) as
    tensors on `device`."""
    def tensor(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return {k: [tensor(t) for t in v] if isinstance(v, list) else tensor(v)
            for k, v in arrays.items()}


@torch.inference_mode()
def infer(model: OcRFDet, batch: Dict[str, torch.Tensor],
          timings: Optional[Dict] = None):
    """Answer one request: (preds, aux, decoded boxes per task,
    detections), with detections one `multi_task_nms` result (numpy
    boxes [M,9] bottom-centred, scores [M], labels [M]) per sample.

    The NMS pair tests of every task and sample run after the decode
    on the decoded boxes' device (`ops/nms.py::nms_rows`: on the card
    one launch), and the host scans their rows.

    With `timings`, it records the request's spans (`utils/spans.py`)
    and returns host-clock seconds: `dispatch` (the forward, the decode
    and the NMS rows issued), `wait` (the decoded boxes and the rows
    copied to the host, which waits for the device) and `nms` (every
    sample's); `spans`, each [name, parent, start_s, end_s] from the
    request's start; `request`, the id the spans share; and `counts`:
    `nms_candidates` and `nms_kept` (boxes into and out of the NMS
    calls), `nms_tasks` and `nms_rows_tasks` (the tasks' NMS calls, and
    those that scanned rows built on the card), `vt_calls` and `vt_replays`
    (the view transformer's calls, and those that replayed its CUDA
    graph: models/detector.py) and, on the card, `allocs` (the caching
    allocator's allocations over the dispatch)."""
    dev = batch["imgs"].device
    head = model.cfg.head
    with spans.recording() if timings is not None else nullcontext() as rec:
        allocs0 = spans.allocations(dev) if rec is not None else None
        with spans.span("ocrfdet.dispatch"):
            with spans.span("ocrfdet.forward"):
                preds, aux = model(batch)
            with spans.span("ocrfdet.decode"):
                decoded = decode_all_tasks(preds, head, model.cfg.grid)
            with spans.span("ocrfdet.nms.rows"):
                rows = nms_rows(decoded, head)
        allocs1 = spans.allocations(dev) if rec is not None else None
        with spans.span("ocrfdet.wait"):
            host = [{k: v.cpu().numpy() for k, v in d._asdict().items()}
                    for d in decoded]
            bits = rows.cpu().numpy().view(np.uint64)
        detections = []
        for b in range(batch["imgs"].shape[0]):
            with spans.span("ocrfdet.nms"):
                detections.append(multi_task_nms(
                    [{k: v[b] for k, v in d.items()} for d in host], head,
                    list(bits[:, b])))
    if rec is not None:
        counts = dict(rec.counts)
        if rows.is_cuda:              # every task scanned the card's rows
            counts["nms_rows_tasks"] = counts.get("nms_tasks", 0)
        if allocs0 is not None:
            counts["allocs"] = allocs1 - allocs0
        timings.update(dispatch=rec.seconds("ocrfdet.dispatch"),
                       wait=rec.seconds("ocrfdet.wait"),
                       nms=rec.seconds("ocrfdet.nms"),
                       spans=rec.relative(), request=rec.request,
                       counts=counts)
    return preds, aux, decoded, detections


def entry(device=None):
    """(fwd, (batch,)) for the flagship eval forward
    `ocrfdet_config(batch_size=1)`; fwd(batch) -> (heatmap of task 0,
    key-frame depth)."""
    device = resolve_device(device)
    cfg = ocrfdet_config(batch_size=1)
    model = build_detector(cfg, device)
    batch = make_batch(cfg, seed=0, device=device)

    @torch.inference_mode()
    def fwd(batch):
        preds, aux = model(batch)
        return preds[0]["heatmap"], aux["depth"]

    return fwd, (batch,)
