"""The data-parallel training state and its collectives (counterpart of
ocrfdet_tpu/parallel/step.py, its `data` and `space` axes).

A rank at (d, s) of the grid (parallel/mesh.py) runs the port's one
training step (`train/step.py`) on the rows of the global batch of its
data index d, as rank s of its space group (the model's space axis,
models/detector.py), with its own dropout generator (the seed and
1024 d + s, as the JAX step folds its mesh indices into its key).
`DataParallelState` supplies the step's collectives, in the JAX step's
order:

  * `mean_fn`: the loss normalisers averaged over the data group only
    (the counts of `compute_losses` come from the targets and carry no
    gradient, so a detached all-reduce is enough; the space ranks hold
    the same rows);
  * `all_mean_`: the gradients, the BatchNorm running statistics and the
    reported losses averaged over the grid, data x space (an explicit
    all-reduce of one flat buffer each, the sum divided by the rank
    count; JAX's `_pmean_both`): every rank holds the global statistics
    (PARITY.md item 8), while the batch statistics inside the forward
    stay local, as under shard_map. Over the space ranks this mean is
    what makes the sharded gradient the unsharded one
    (parallel/collectives.py). The
    non-finite guard then reads the averaged gradients and loss, so
    every rank skips together; a skipped step changes nothing (the JAX
    step still moves its EMA on a skipped step);
  * ZeRO (`ZeroLayout`, JAX's `zero_sharding`): each rank of the grid
    keeps and updates only its slice of AdamW's moments and of both
    EMAs, along each tensor's first axis whose size the grid's rank
    count divides; a tensor
    with no such axis is replicated. The clip reads the whole averaged
    gradients; after AdamW, `gather_` all-gathers the new parameter
    slices on every rank.

`DataParallelState.state_dict` gathers the whole state (the
single-device `TrainState`'s layout plus every rank's dropout
generator), so a checkpoint written by N ranks resumes on any number.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import entry
from ..config import OcRFDetConfig
from ..train.step import TrainState
from ..utils.weights import init_weights
from .collectives import count
from .mesh import DataMesh
from .multihost import gather_objects


class ZeroLayout:
    """Which slice of a tensor a data rank keeps: along the first axis
    whose size is at least the rank count n and a multiple of it, the
    rank's n-th; a tensor without such an axis whole."""

    def __init__(self, n: int, rank: int):
        self.n, self.rank = n, rank

    def axis(self, shape: Sequence[int]) -> Optional[int]:
        for i, d in enumerate(shape):
            if d >= self.n and d % self.n == 0:
                return i
        return None

    def part(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank `rank`'s view of t (t itself where it is replicated)."""
        ax = self.axis(t.shape)
        if ax is None:
            return t
        size = t.shape[ax] // self.n
        return t.narrow(ax, rank * size, size)

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        return self.part(t, self.rank)

    @torch.no_grad()
    def gather(self, shards: List[torch.Tensor], fulls: List[torch.Tensor],
               group) -> None:
        """Write every rank's `shards` (this rank's view of each of
        `fulls`, or a copy of it) into `fulls` on every rank: one
        all-gather of the concatenated slices."""
        pairs = [(s, f) for s, f in zip(shards, fulls)
                 if self.axis(f.shape) is not None]
        if not pairs:
            return
        flat = torch.cat([s.reshape(-1) for s, _ in pairs])
        parts = [torch.empty_like(flat) for _ in range(self.n)]
        count("grid_all_gather", flat)
        dist.all_gather(parts, flat, group=group)
        for r, part in enumerate(parts):
            views = [self.part(f, r) for _, f in pairs]
            torch._foreach_copy_(views, [
                p.view(v.shape) for p, v in zip(
                    part.split([s.numel() for s, _ in pairs]), views)])


class DataParallelState(TrainState):
    """`TrainState` of one data rank: the whole model (replicated), the
    rank's dropout generator, and its ZeRO slice of AdamW's moments and
    of both EMAs."""

    def __init__(self, cfg: OcRFDetConfig, model, mesh: DataMesh,
                 steps_per_epoch: int = 100, seed: int = 0):
        self.mesh = mesh
        self.n = mesh.data * mesh.space        # the grid's ranks
        self.layout = ZeroLayout(self.n, mesh.rank)
        model.set_space(mesh.space_axis)
        super().__init__(cfg, model, steps_per_epoch, seed,
                         stream=1024 * mesh.d + mesh.s,
                         shard=self.layout.shard)
        names = dict(self.model.named_parameters())
        names.update(self.model.named_buffers())
        # the whole tensor behind each moment and EMA slice, by name
        self.full_of = {
            **{f"{kind}.{n}": names[n] for n in
               self.optimizer.names["render"] + self.optimizer.names["other"]
               for kind in ("m", "v")},
            **{n: names[n] for n in self.ema_params.names},
            **{n: names[n] for n in self.ema_stats.names}}

    # ------------------------------------------- the step's collectives
    def mean_fn(self, x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone()
        dist.all_reduce(x, group=self.mesh.group)
        return x / self.mesh.data

    @torch.no_grad()
    def all_mean_(self, tensors: List[torch.Tensor]) -> None:
        """In place: each tensor the mean of its values over the grid
        (the sum of one flat buffer divided by the rank count)."""
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        count("grid_all_reduce", flat)
        dist.all_reduce(flat, group=self.mesh.grid)
        flat.div_(self.n)
        parts = flat.split([t.numel() for t in tensors])
        torch._foreach_copy_(tensors, [p.view(t.shape)
                                       for p, t in zip(parts, tensors)])

    def gather_(self, params: List[torch.Tensor]) -> None:
        if self.n > 1:   # at one rank every slice is already here
            self.layout.gather([self.layout.shard(p) for p in params],
                               params, self.mesh.grid)

    # ------------------------------------------------------ checkpoints
    def _gathered(self, shards: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        fulls = {k: torch.empty_like(self.full_of[k], dtype=t.dtype)
                 for k, t in shards.items()}
        for k, t in shards.items():
            if self.layout.axis(fulls[k].shape) is None:     # replicated
                fulls[k].copy_(t)
        self.layout.gather(list(shards.values()), list(fulls.values()),
                           self.mesh.grid)
        return fulls

    def state_dict(self) -> Dict:
        """The single-device `TrainState.state_dict()` of the whole state
        (every rank must call it: it gathers the slices), plus every
        rank's dropout generator under "generators", by rank of the grid;
        "generator" is rank 0's."""
        gens = gather_objects(self.generator.get_state(), self.mesh.grid)
        return dict(step=self.step, model=self.model.state_dict(),
                    optimizer=self._gathered(self.optimizer.state_dict()),
                    ema_params=self._gathered(self.ema_params.as_dict()),
                    ema_stats=self._gathered(self.ema_stats.as_dict()),
                    generator=gens[0], generators=gens)

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        """Restore a whole state (from any number of ranks, or from a
        single-device run) into this rank's slices. A rank the
        checkpoint holds no generator for keeps its seeded one."""
        self.model.load_state_dict(sd["model"], strict=True)
        for mine, full in ((self.optimizer.state_dict(), sd["optimizer"]),
                           (self.ema_params.as_dict(), sd["ema_params"]),
                           (self.ema_stats.as_dict(), sd["ema_stats"])):
            if set(mine) != set(full):
                raise KeyError(
                    f"state: missing {sorted(set(mine) - set(full))}, "
                    f"unexpected {sorted(set(full) - set(mine))}")
            for k, t in mine.items():
                t.copy_(self.layout.shard(full[k].to(t.device)))
        gens = sd.get("generators", [sd["generator"]])
        if self.mesh.rank < len(gens):
            self.generator.set_state(gens[self.mesh.rank].cpu())
        self.step = int(sd["step"])


def build_trainer(cfg: OcRFDetConfig, mesh: DataMesh, seed: int = 0,
                  steps_per_epoch: int = 100) -> DataParallelState:
    """`entry.build_trainer` for one rank of the grid: the same seeded
    model on the rank's device, on the rank's space axis, in a
    `DataParallelState`."""
    if mesh.space != cfg.parallel.space_axis:
        raise ValueError(f"a mesh of space {mesh.space} for "
                         f"parallel.space_axis {cfg.parallel.space_axis}")
    model = init_weights(entry.detector_class(cfg)(cfg, render_heads=True),
                         seed).to(mesh.device)
    return DataParallelState(cfg, model, mesh, steps_per_epoch, seed)
