"""The single-device training step (counterpart of
ocrfdet_tpu/parallel/step.py::build_train_step on a 1 x 1 mesh, without
its collectives and ZeRO sharding).

One step: the forward of every frame in train mode (BatchNorm batch
statistics, ASPP dropout from the state's generator, the render branch
on K5), every loss of `compute_losses`, the backward through the
kernels' backward, then the non-finite guard, the clip (5), AdamW with
the render-lr group, the EMA of the parameters and the BatchNorm
statistics, and the step count.

The guard reads the device once per step: the loss, the sum of |grad|
over every parameter and the loss dict come to the host together, and
if the loss or that sum is not finite the whole update is skipped: the
parameters, the optimizer state, the EMA and the step count stay as they
were, and the BatchNorm statistics, which the forward moved in place,
are restored from a copy taken before it. (The JAX step gates the same
update on the device with `where`, but still moves its EMA toward the
unchanged parameters on a skipped step; here a skipped step changes
nothing.) The state is updated in place.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import OcRFDetConfig
from ..models.detector import OcRFDet
from ..models.norm import BatchNorm1d, BatchNorm2d
from .optim import EMA, Optimizer, ema_decay
from .trainstep import compute_losses, total_loss


class TrainState:
    """Model (train mode), optimizer state, EMA, step count and the
    dropout generator of one training run."""

    def __init__(self, cfg: OcRFDetConfig, model: OcRFDet,
                 steps_per_epoch: int = 100, seed: int = 0):
        self.cfg = cfg
        self.model = model.train()
        self.step = 0
        dev = next(model.parameters()).device
        self.generator = torch.Generator(device=dev).manual_seed(seed + 17)
        model.set_dropout_generator(self.generator)
        self.optimizer = Optimizer(cfg.optim, model.named_parameters(),
                                   steps_per_epoch)
        bns = [(n, m) for n, m in model.named_modules()
               if isinstance(m, (BatchNorm1d, BatchNorm2d))]
        # the BatchNorm buffers a skipped step restores
        self.bn_buffers = [t for _, m in bns for t in
                           (m.running_mean, m.running_var,
                            m.num_batches_tracked)]
        self.bn_snapshot = [t.clone() for t in self.bn_buffers]
        frozen = set(self.optimizer.names["frozen"])
        self.ema_params = EMA({n: p for n, p in model.named_parameters()
                               if n not in frozen})
        self.ema_stats = EMA({f"{n}.{k}": getattr(m, k) for n, m in bns
                              for k in ("running_mean", "running_var")})


def train_step(state: TrainState, batch: Dict) -> Dict[str, float]:
    """One training step on `batch` (tensors on the model's device, from
    `entry.make_batch(..., with_targets=True)`). Returns the loss dict,
    `loss_total` and `skipped_nonfinite` (0.0 or 1.0) as floats."""
    cfg, model = state.cfg, state.model
    params = state.optimizer.params()
    for p in params:
        p.grad = None
    torch._foreach_copy_(state.bn_snapshot, state.bn_buffers)
    preds, aux = model(batch)
    losses = compute_losses(cfg, preds, aux, batch)
    loss = total_loss(losses)
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    gsum = torch.stack(torch._foreach_norm(grads, 1.0)).sum()
    names = list(losses)
    host = torch.stack([loss.detach(), gsum] + [losses[k].detach().float()
                                                for k in names]).tolist()
    metrics = dict(zip(names, host[2:]), loss_total=host[0])
    ok = bool(np.isfinite(host[0]) and np.isfinite(host[1]))
    metrics["skipped_nonfinite"] = 0.0 if ok else 1.0
    if not ok:
        with torch.no_grad():
            torch._foreach_copy_(state.bn_buffers, state.bn_snapshot)
        for p in params:
            p.grad = None
        return metrics
    state.optimizer.update(grads, state.step)
    d = ema_decay(cfg.optim, state.step)
    state.ema_params.update(d)
    state.ema_stats.update(d)
    state.step += 1
    for p in params:
        p.grad = None
    return metrics
