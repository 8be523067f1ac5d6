"""BatchNorm with flax's running statistics.

In train mode `torch.nn.BatchNorm*d` moves `running_var` toward the
*unbiased* batch variance (times n/(n-1)); flax's `BatchNorm` (momentum
0.9, torch's 0.1) moves it toward the biased one. In train mode the
modules here normalise with the batch statistics and then, unless
frozen, move the running statistics toward the biased ones:
running = (1 - m) running + m batch. `BatchNorm2d` normalises through
`torch._batch_norm_impl_index`, the op behind `F.batch_norm` (cuDNN
where it applies), called with no running statistics: it also returns
the batch mean and 1 / sqrt(var + eps). `BatchNorm1d`, and a
`BatchNorm2d` with one value per channel (a pooled input at batch 1),
where torch's module refuses to train, compute flax's own formula, which
there normalises with a zero variance. In eval they are torch's.

With the `space` axis (`axis`, parallel/collectives.py::Axis), a
train-mode `BatchNorm2d` on a row block of the BEV grid sums x and x^2
over its block in fp32, all-reduces the sums over the axis (`psum`,
whose backward is the all-reduce of the cotangents) and normalises with
the whole grid's statistics, flax's `BatchNorm(axis_name=...)`
(mean = E[x], var = max(E[x^2] - mean^2, 0)); the running statistics
move as above. Halo rows never reach a BatchNorm: the conv before it
consumed them.

`frozen_stats()` stops the update (the batch statistics still
normalise): the recomputation of a checkpointed block in the backward
runs under it, so that a block's statistics move once per forward, as
in flax, where a remat block's recomputation changes no variable.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from ..parallel.collectives import psum

_update = [True]


@contextlib.contextmanager
def frozen_stats():
    """Train-mode BatchNorm inside normalises with batch statistics but
    leaves its running statistics as they are."""
    prev = _update[0]
    _update[0] = False
    try:
        yield
    finally:
        _update[0] = prev


@torch.no_grad()
def _update_running(bn, mean, var):
    """Move bn's running statistics toward the batch's (biased) mean and
    variance, unless frozen."""
    if not _update[0]:
        return
    m = bn.momentum
    bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
    bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
    bn.num_batches_tracked.add_(1)


def _synced_batch_norm(bn, x, axis):
    """Train-mode batch norm of x [B, C, Yl, X] with the statistics of
    every rank's block of the axis; returns (y in x's dtype, mean, var)."""
    xf = x.float()
    dims = [0, 2, 3]
    sums = psum(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]), axis)
    n = x.numel() // x.shape[1] * axis.size
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    shape = (1, -1, 1, 1)
    y = ((xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + bn.eps)
         * bn.weight.view(shape) + bn.bias.view(shape))
    return y.to(x.dtype), mean, var


class _FlaxRunningStats:
    flax_formula = False

    def forward(self, x, axis=None):
        if not self.training:
            return super().forward(x)
        if axis is not None:
            y, mean, var = _synced_batch_norm(self, x, axis)
        elif self.flax_formula or x.numel() == x.shape[1]:
            # flax's formula; with one value per channel it gives exactly
            # the bias, as flax does
            dims = [d for d in range(x.dim()) if d != 1]
            shape = [1] * x.dim()
            shape[1] = x.shape[1]
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            y = ((x - mean.view(shape)) * torch.rsqrt(var.view(shape)
                                                      + self.eps)
                 * self.weight.view(shape) + self.bias.view(shape))
        else:
            y, mean, invstd, _, _ = torch._batch_norm_impl_index(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps,
                torch.backends.cudnn.enabled)
            var = torch.clamp(invstd.pow(-2) - self.eps, min=0.0)
        _update_running(self, mean, var)
        return y


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    """[N, C] only. In train mode the statistics are flax's own formula,
    var = max(E[x^2] - E[x]^2, 0) (the camera-parameter input has
    near-constant columns, where eps dominates and the two formulas'
    rounding would differ visibly); it is a 27-wide op."""
    flax_formula = True


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    pass
