"""Optimizer, learning-rate schedules and EMA (counterpart of
ocrfdet_tpu/train/optim.py, optax's semantics written out in PyTorch).

  * global-norm gradient clip (5), then AdamW (b1 0.9, b2 0.999, eps 1e-8
    outside the square root, bias-corrected moments, weight decay 1e-2 on
    every parameter, added to the Adam direction before the learning
    rate, as `optax.adamw`);
  * learning rate: linear warm-up from `warmup_ratio` over `warmup_iters`
    steps, then constant;
  * the render MLPs (`RENDER_LR_KEYS`) get `lr_mult_render` times the
    rate, decayed by `render_lr_decay_per_epoch` every epoch;
  * the `frozen` partition, GeoEnhDet's VGGT teacher (every parameter
    under the top-level `aggregator`), gets no gradient, no update, no
    optimizer state and no EMA copy; the clip's global norm is that of
    the other parameters (JAX's frozen gradients are zeros);
  * MEGVII EMA over the parameters and the BatchNorm statistics, decay
    0.999 (1 - exp(-(updates + 10560) / 2000)).
Each schedule reads the count of committed updates, as optax's counts.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ..config import OptimConfig

# parameter-name substrings that get the render learning rate
RENDER_LR_KEYS = (
    "S_MLP", "R_MLP", "A_MLP", "C_MLP", "C_MLP_nerf", "D_MLP_nerf",
    "sigma", "img_feat_resize1", "img_feat_resize2",
)


def is_render_param(name: str) -> bool:
    return any(k in name for k in RENDER_LR_KEYS)


def is_frozen_param(name: str) -> bool:
    """The top-level `aggregator`, the VGGT teacher of GeoEnhDet, is
    frozen, as in the JAX package; nothing of OcRFDet is."""
    return name.split(".", 1)[0] == "aggregator"


def param_groups(named_params) -> Dict[str, List]:
    """{"render": [(name, p)], "other": [...], "frozen": [...]}."""
    groups: Dict[str, List] = {"render": [], "other": [], "frozen": []}
    for name, p in named_params:
        key = ("frozen" if is_frozen_param(name)
               else "render" if is_render_param(name) else "other")
        groups[key].append((name, p))
    return groups


def lr_at(cfg: OptimConfig, step: int) -> float:
    """The base learning rate after `step` committed updates (fp32)."""
    f32 = np.float32
    warm = f32(cfg.warmup_ratio) + f32(1.0 - cfg.warmup_ratio) * min(
        f32(step) / f32(max(cfg.warmup_iters, 1)), f32(1.0))
    return float(f32(cfg.lr) * warm)


def render_mult_at(cfg: OptimConfig, step: int, steps_per_epoch: int) -> float:
    epoch = math.floor(step / steps_per_epoch)
    return float(np.float32(cfg.lr_mult_render)
                 * np.float32(cfg.render_lr_decay_per_epoch) ** epoch)


def ema_decay(cfg: OptimConfig, updates: int) -> float:
    """MEGVII ramped decay with the pre-warmed counter (fp32)."""
    u = np.float32(updates + cfg.ema_init_updates)
    return float(np.float32(cfg.ema_decay)
                 * (np.float32(1.0) - np.exp(-u / np.float32(2000.0))))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """In place: scale every gradient by max_norm / ||g|| where the
    global norm ||g|| is at least max_norm."""
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads, 2.0)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


class AdamW:
    """optax.adamw over one parameter group, learning rate given per
    update."""

    def __init__(self, params: List[torch.Tensor], weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.wd, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], count: int, lr: float):
        """One update; `count` is the number of earlier updates."""
        if not self.params:
            return
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.m, b1)
        torch._foreach_add_(self.m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.v, b2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1.0 - b2)
        t = count + 1
        bc1 = float(1.0 - np.float32(b1) ** t)
        bc2 = float(1.0 - np.float32(b2) ** t)
        denom = torch._foreach_div(self.v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.m, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, self.params, alpha=self.wd)
        torch._foreach_add_(self.params, upd, alpha=-lr)

    def state_tensors(self) -> List[torch.Tensor]:
        return self.m + self.v


class Optimizer:
    """The JAX package's `make_optimizer`: the global-norm clip over every
    trainable parameter, then AdamW per group at the group's learning
    rate (`lr_at`, times `render_mult_at` for the render group). The
    frozen group gets no gradient and no optimizer state. With `shard`
    (a ZeRO layout's view of a tensor: `parallel/step.py`), AdamW keeps
    moments for, and updates, only each parameter's view; the clip reads
    the whole gradients."""

    def __init__(self, cfg: OptimConfig, named_params, steps_per_epoch: int,
                 shard=None):
        self.cfg, self.steps_per_epoch = cfg, steps_per_epoch
        self.shard = shard or (lambda t: t)
        groups = param_groups(named_params)
        for _, p in groups["frozen"]:
            p.requires_grad_(False)
        self.names = {k: [n for n, _ in v] for k, v in groups.items()}
        self.full = {k: [p for _, p in groups[k]] for k in ("render", "other")}
        with torch.no_grad():
            self.groups = {k: AdamW([self.shard(p) for p in self.full[k]],
                                    cfg.weight_decay)
                           for k in ("render", "other")}

    def params(self) -> List[torch.Tensor]:
        """The trainable parameters, render group first."""
        return self.full["render"] + self.full["other"]

    def state_tensors(self) -> List[torch.Tensor]:
        return [t for g in self.groups.values() for t in g.state_tensors()]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The moments by "{m|v}.{parameter name}"."""
        out = {}
        for k, g in self.groups.items():
            for kind, ts in (("m", g.m), ("v", g.v)):
                out.update((f"{kind}.{n}", t)
                           for n, t in zip(self.names[k], ts))
        return out

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Copy `state_dict()`'s tensors in place; the keys must match."""
        _copy_in_place(self.state_dict(), sd, "optimizer")

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], count: int) -> None:
        """One update of `params()` from `grads` (in that order, clipped
        in place); `count` is the number of earlier updates."""
        clip_by_global_norm(grads, self.cfg.grad_clip_norm)
        grads = [self.shard(g) for g in grads]
        n = len(self.groups["render"].params)
        lr = lr_at(self.cfg, count)
        mult = render_mult_at(self.cfg, count, self.steps_per_epoch)
        self.groups["render"].update(grads[:n], count,
                                     float(np.float32(lr) * np.float32(mult)))
        self.groups["other"].update(grads[n:], count, lr)


class EMA:
    """EMA copies (fp32) of `tensors`, updated toward their values."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.names = list(tensors)
        self.src = [tensors[k] for k in self.names]
        self.ema = [t.detach().float().clone() for t in self.src]

    @torch.no_grad()
    def update(self, decay: float) -> None:
        torch._foreach_mul_(self.ema, decay)
        torch._foreach_add_(self.ema, [t.float() for t in self.src],
                            alpha=1.0 - decay)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.ema))

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Copy `as_dict()`'s tensors in place; the keys must match."""
        _copy_in_place(self.as_dict(), sd, "EMA")


@torch.no_grad()
def _copy_in_place(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
                   what: str) -> None:
    if set(dst) != set(src):
        raise KeyError(f"{what} state: missing {sorted(set(dst) - set(src))}"
                       f", unexpected {sorted(set(src) - set(dst))}")
    for k, t in dst.items():
        t.copy_(src[k])
