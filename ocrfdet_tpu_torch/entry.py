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
LSS slice. `entry()` returns the flagship eval forward and its example
batch, as the JAX package's `__graft_entry__.entry()` does. Everything
runs on the card unless the caller passes `device="cpu"`; without CUDA
the default device raises.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .config import OcRFDetConfig, ocrfdet_config
from .core.coder import decode_all_tasks
from .data import synthetic
from .models.detector import OcRFDet
from .ops.nms import multi_task_nms
from .train.step import TrainState, train_step  # noqa: F401 (entry point)
from .utils.weights import init_weights


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda", which must be available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return device


def build_detector(cfg: Optional[OcRFDetConfig] = None, device=None,
                   seed: int = 0) -> OcRFDet:
    """The eval-mode detector with seeded random weights on `device`."""
    device = resolve_device(device)
    cfg = cfg or ocrfdet_config(batch_size=1)
    model = init_weights(OcRFDet(cfg), seed)
    return model.eval().to(device)


def build_trainer(cfg: Optional[OcRFDetConfig] = None, device=None,
                  seed: int = 0, steps_per_epoch: int = 100) -> TrainState:
    """The training state of `cfg` (default the flagship
    `ocrfdet_config()`, batch from the batches given to `train_step`):
    the model with its render heads and seeded random weights in train
    mode on `device`, AdamW state, EMA, step 0."""
    device = resolve_device(device)
    cfg = cfg or ocrfdet_config()
    model = init_weights(OcRFDet(cfg, render_heads=True), seed).to(device)
    return TrainState(cfg, model, steps_per_epoch=steps_per_epoch, seed=seed)


def make_batch(cfg: OcRFDetConfig, seed: int = 0, batch_size: int = 1,
               device=None, with_targets: bool = False) -> Dict:
    """A synthetic request as tensors on `device`; with `with_targets`
    a training batch (the per-task targets as lists of tensors)."""
    device = resolve_device(device)
    batch = synthetic.make_batch(cfg, batch_size=batch_size, seed=seed,
                                 with_targets=with_targets)

    def tensor(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return {k: [tensor(t) for t in v] if isinstance(v, list) else tensor(v)
            for k, v in batch.items()}


@torch.inference_mode()
def infer(model: OcRFDet, batch: Dict[str, torch.Tensor],
          timings: Optional[Dict[str, float]] = None):
    """Answer one request: (preds, aux, decoded boxes per task,
    detections), with detections one `multi_task_nms` result (numpy
    boxes [M,9] bottom-centred, scores [M], labels [M]) per sample.

    With `timings`, it records host-clock seconds: `dispatch` (the
    forward and the decode issued), `wait` (the decoded boxes copied to
    the host, which waits for the device) and `nms`."""
    t0 = time.perf_counter()
    preds, aux = model(batch)
    decoded = decode_all_tasks(preds, model.cfg.head, model.cfg.grid)
    t1 = time.perf_counter()
    host = [{k: v.cpu().numpy() for k, v in d._asdict().items()}
            for d in decoded]
    t2 = time.perf_counter()
    B = batch["imgs"].shape[0]
    detections = [multi_task_nms([{k: v[b] for k, v in d.items()}
                                  for d in host], model.cfg.head)
                  for b in range(B)]
    if timings is not None:
        timings.update(dispatch=t1 - t0, wait=t2 - t1,
                       nms=time.perf_counter() - t2)
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
