"""The training step (counterpart of
ocrfdet_tpu/parallel/step.py::build_train_step), on one device or as one
rank of the data axis: the state's hooks (`TrainState.mean_fn`,
`all_mean_`, `gather_`) are the step's collectives, none on one device,
and `parallel/step.py::DataParallelState` supplies them over the ranks.

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

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import OcRFDetConfig
from ..models.detector import OcRFDet
from ..models.norm import BatchNorm1d, BatchNorm2d
from .optim import EMA, Optimizer, ema_decay
from .trainstep import compute_losses, total_loss


class TrainState:
    """Model (train mode), optimizer state, EMA, step count and the
    dropout generator of one training run. A data-parallel run
    (`parallel/step.py`) gives each rank its own dropout generator
    (`stream` 1024 d + s, as the JAX step folds its mesh indices into
    its key) and keeps the moments and the EMAs of each tensor's `shard`
    only."""

    def __init__(self, cfg: OcRFDetConfig, model: OcRFDet,
                 steps_per_epoch: int = 100, seed: int = 0, stream: int = 0,
                 shard=None):
        self.cfg = cfg
        self.model = model.train()
        self.step = 0
        dev = next(model.parameters()).device
        self.generator = torch.Generator(device=dev).manual_seed(
            seed + 17 + stream)
        model.set_dropout_generator(self.generator)
        self.optimizer = Optimizer(cfg.optim, model.named_parameters(),
                                   steps_per_epoch, shard=shard)
        shard = shard or (lambda t: t)
        bns = [(n, m) for n, m in model.named_modules()
               if isinstance(m, (BatchNorm1d, BatchNorm2d))]
        # the BatchNorm buffers a skipped step restores
        self.bn_buffers = [t for _, m in bns for t in
                           (m.running_mean, m.running_var,
                            m.num_batches_tracked)]
        self.bn_snapshot = [t.clone() for t in self.bn_buffers]
        self.bn_stats = [t for t in self.bn_buffers if t.is_floating_point()]
        frozen = set(self.optimizer.names["frozen"])
        with torch.no_grad():
            self.ema_params = EMA({n: shard(p)
                                   for n, p in model.named_parameters()
                                   if n not in frozen})
            self.ema_stats = EMA({f"{n}.{k}": shard(getattr(m, k))
                                  for n, m in bns
                                  for k in ("running_mean", "running_var")})

    def state_dict(self) -> Dict:
        """What a resumed run needs to continue bit for bit: the step
        count, the model's parameters and buffers (the BatchNorm
        statistics and `num_batches_tracked`), the optimizer's moments,
        both EMAs and the dropout generator's state."""
        return dict(step=self.step, model=self.model.state_dict(),
                    optimizer=self.optimizer.state_dict(),
                    ema_params=self.ema_params.as_dict(),
                    ema_stats=self.ema_stats.as_dict(),
                    generator=self.generator.get_state())

    def load_state_dict(self, sd: Dict) -> None:
        """Restore `state_dict()` in place (strict: every key must
        match)."""
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.ema_params.load_state_dict(sd["ema_params"])
        self.ema_stats.load_state_dict(sd["ema_stats"])
        self.generator.set_state(sd["generator"].cpu())
        self.step = int(sd["step"])

    # The collectives of a step over the data ranks, which
    # `parallel/step.py::DataParallelState` overrides; on one device
    # there are none.
    def mean_fn(self, x: torch.Tensor) -> torch.Tensor:
        """A loss normaliser's mean over the data ranks."""
        return x

    def all_mean_(self, tensors: List[torch.Tensor]) -> None:
        """In place: each tensor the mean of its values over the ranks."""

    def gather_(self, params: List[torch.Tensor]) -> None:
        """In place: every rank's slice of the updated parameters."""


def forward_backward(state: TrainState, batch: Dict
                     ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The forward and backward of `batch` (on a data rank, its rows),
    then the gradients, the BatchNorm running statistics and the losses
    averaged over the data ranks (`state.all_mean_`; on one device
    nothing). The BatchNorm statistics are saved first for the guard.
    Returns (the gradients of `optimizer.params()`, the losses and
    `loss_total` as 0-d fp32 tensors)."""
    cfg, model = state.cfg, state.model
    params = state.optimizer.params()
    for p in params:
        p.grad = None
    torch._foreach_copy_(state.bn_snapshot, state.bn_buffers)
    preds, aux = model(batch)
    losses = compute_losses(cfg, preds, aux, batch, mean_fn=state.mean_fn)
    loss = total_loss(losses)
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    names = list(losses) + ["loss_total"]
    with torch.no_grad():
        reported = torch.stack([losses[k].detach().float()
                                for k in names[:-1]] + [loss.detach()])
        state.all_mean_(grads)
        state.all_mean_(state.bn_stats)
        state.all_mean_([reported])
    return grads, dict(zip(names, reported))


def apply_update(state: TrainState, grads: List[torch.Tensor],
                 losses: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The guard on `grads` and `losses["loss_total"]`, then the clip,
    AdamW (on a data rank, of its ZeRO slices, then `state.gather_`
    of the new parameters), the EMAs and the step count. Returns the
    losses, `loss_total` and `skipped_nonfinite` (0.0 or 1.0) as
    floats."""
    params = state.optimizer.params()
    gsum = torch.stack(torch._foreach_norm(grads, 1.0)).sum()
    names = list(losses)
    host = torch.stack([gsum] + [losses[k] for k in names]).tolist()
    metrics = dict(zip(names, host[1:]))
    ok = bool(np.isfinite(metrics["loss_total"]) and np.isfinite(host[0]))
    metrics["skipped_nonfinite"] = 0.0 if ok else 1.0
    if ok:
        state.optimizer.update(grads, state.step)
        state.gather_(params)
        d = ema_decay(state.cfg.optim, state.step)
        state.ema_params.update(d)
        state.ema_stats.update(d)
        state.step += 1
    else:
        with torch.no_grad():
            torch._foreach_copy_(state.bn_buffers, state.bn_snapshot)
    for p in params:
        p.grad = None
    return metrics


def train_step(state: TrainState, batch: Dict) -> Dict[str, float]:
    """One training step on `batch` (tensors on the model's device, from
    `entry.make_batch(..., with_targets=True)`; on a data rank its rows,
    and every data rank calls it together). Returns the loss dict,
    `loss_total` and `skipped_nonfinite` (0.0 or 1.0) as floats, on a
    data rank averaged over the ranks."""
    return apply_update(state, *forward_backward(state, batch))
