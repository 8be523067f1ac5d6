"""Collectives of the `space` axis, each with its transpose as its
backward (counterpart of ocrfdet_tpu/parallel/collectives.py).

The gradient convention. Every rank of a space group runs the whole
forward on its cameras or its rows, and computes the same replicated
loss. The training step then averages the raw gradients over the
`data x space` grid (`parallel/step.py::DataParallelState.all_mean_`,
JAX's `_pmean_both`). Each collective's backward is its forward's
transpose as a linear map across the ranks:

  * `psum` (all-reduce, sum): its backward is the all-reduce of the
    cotangents;
  * `all_gather_cat` (the ranks' blocks concatenated along a dim): its
    backward sums the cotangents over the ranks and keeps the rank's
    own block (a reduce-scatter);
  * `halo_exchange_rows` (halo.py; the neighbours' boundary rows): its
    backward sends each halo row's cotangent back to the rank that owns
    the row, which adds it into its boundary row.

Why that gives the unsharded gradient exactly (factor 1). A replicated
part of the graph gets the same gradient on every rank, so its mean is
that gradient. A sharded part (a camera block, a row block) sits behind
one of these collectives: every rank's loss depends on every rank's
block, so the transposes sum the S ranks' identical cotangents and hand
each block S times its partial gradient; the mean over the S ranks then
leaves the sum of the partials, which is the unsharded gradient. This is
the argument of JAX's `all_gather_invariant`, whose `pmean` after the
gather does the same bookkeeping inside the backward (round 4 of the JAX
package measured a factor 2.000 at S = 2 before that fix): here the
division happens once, in the step's mean.

Only `all_reduce` and the list form of `all_gather` are used, which
NCCL takes for CUDA tensors and gloo takes for CPU and CUDA tensors
alike (torch 2.11 on an H100, 2.13 on the CPU), so one code path serves
every backend: the reduce-scatter is an all-reduce followed by the
rank's slice. Each collective has a no-grad form (`all_reduce_sum`,
`all_gather_dim`, `reduce_scatter_dim`) that the autograd functions'
forwards and backwards call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One axis of the process grid as the model sees it: its process
    group, its size and this rank's index on it."""
    group: Any
    size: int
    index: int

    def __post_init__(self):
        if not 0 <= self.index < self.size:
            raise ValueError(f"axis index {self.index} of size {self.size}")


# the count and bytes of each collective since the last reset, by name
# (read by chip_smoke.py's [space] phase)
STATS: dict = {}


def count(name: str, t: torch.Tensor) -> None:
    """Add one call of collective `name` on `t` to STATS."""
    n, b = STATS.get(name, (0, 0))
    STATS[name] = (n + 1, b + t.numel() * t.element_size())


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of x over the axis' ranks (a new tensor)."""
    y = x.detach().contiguous().clone()
    count("all_reduce", y)
    dist.all_reduce(y, group=axis.group)
    return y


def all_gather_dim(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' x concatenated along `dim`, in rank order."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    count("all_gather", x)
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim)


def reduce_scatter_dim(x: torch.Tensor, axis: Axis, dim: int
                       ) -> torch.Tensor:
    """The sum of x over the ranks, then this rank's block along `dim`
    (x.shape[dim] / size rows)."""
    n = x.shape[dim] // axis.size
    return all_reduce_sum(x, axis).narrow(dim, axis.index * n, n) \
        .contiguous()


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axis), None


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather_dim(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.axis, ctx.dim), None, None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """All-reduce (sum) over the axis; backward: the same."""
    return _PSum.apply(x, axis)


def all_gather_cat(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' blocks concatenated along `dim`; backward: the
    cotangents summed over the ranks, then this rank's block."""
    return _AllGatherCat.apply(x, axis, dim % x.dim())
