"""The process grid of the `data` and `space` axes (counterpart of
ocrfdet_tpu/parallel/mesh.py).

The JAX package drives a (data, space) device mesh from one process.
The port runs one process per rank (`torchrun`), and its axes are
`torch.distributed` process groups. World = data x space (+ idle
ranks): rank r sits at (d, s) = (r // space, r % space), the order of
JAX's `make_mesh` (`devices.reshape(data, space)`). The JAX trainer
takes `data = min(devices // space, batch_size)` (its trainer.py); a
rank at or past data x space holds no data and joins no collective.

Each rank joins:
  * its data group: the ranks with its s (they hold different rows of
    the batch: the loss normalisers are averaged over it);
  * its space group: the ranks with its d (they hold the same rows and
    split the cameras, the BEV rows and the render bands:
    `collectives.Axis`, models/detector.py);
  * the grid: every rank of data x space (the gradients, the BatchNorm
    statistics and the losses are averaged over it, and the ZeRO slices
    of parallel/step.py are the grid's).

The backend: NCCL on cards, gloo on the CPU, and gloo on a card that
more than one rank shares (NCCL refuses two ranks on one device). At
space 1 the data group is the grid.

    torchrun --nproc-per-node 4 -m ocrfdet_tpu_torch.tools.train \
        --multihost --infos INFOS.pkl --work-dir work/ocrfdet
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .collectives import Axis


@dataclass(frozen=True)
class DataMesh:
    """This process's place on the (data, space) grid."""
    rank: int
    world: int
    data: int                  # ranks on the data axis
    device: torch.device
    group: Optional[object]    # the data group (the ranks with this s)
    space: int = 1             # ranks on the space axis
    space_group: Optional[object] = None    # the ranks with this d
    grid: Optional[object] = None           # every rank of data x space
    backend: str = "gloo"

    @property
    def active(self) -> bool:
        """Whether this rank holds data (rank < data x space)."""
        return self.rank < self.data * self.space

    @property
    def d(self) -> int:
        return self.rank // self.space

    @property
    def s(self) -> int:
        return self.rank % self.space

    @property
    def space_axis(self) -> Optional[Axis]:
        """The space axis the model of this rank runs on (None at space
        1)."""
        if self.space == 1 or not self.active:
            return None
        return Axis(self.space_group, self.space, self.s)


def init_data_mesh(batch_size: int, device=None, space: int = 1
                   ) -> DataMesh:
    """Join the process group that `torchrun` describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) and build the data, space and grid groups,
    which every rank must create. `device` "cpu" runs gloo on the CPU;
    otherwise the rank's card, cuda:(LOCAL_RANK modulo the cards), with
    NCCL, or with gloo where the node's ranks outnumber its cards."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if world < space:
        raise ValueError(f"world size {world} is smaller than the space "
                         f"axis {space}")
    if device is not None and torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
        if int(os.environ.get("LOCAL_WORLD_SIZE", 1)) > n_cards:
            backend = "gloo"
            print(f"rank {rank}: gloo on {dev}: the node's ranks share its "
                  f"cards", flush=True)
        else:
            backend = "nccl"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    data = min(world // space, batch_size)     # the JAX trainer's rule
    n = data * space
    # every rank creates every group, in the same order
    data_groups = [dist.new_group([d * space + s for d in range(data)])
                   for s in range(space)]
    if space == 1:
        return DataMesh(rank, world, data, dev,
                        data_groups[0] if rank < n else None,
                        grid=data_groups[0] if rank < n else None,
                        backend=backend)
    space_groups = [dist.new_group([d * space + s for s in range(space)])
                    for d in range(data)]
    grid = dist.new_group(list(range(n)))
    if rank >= n:
        return DataMesh(rank, world, data, dev, None, space, backend=backend)
    return DataMesh(rank, world, data, dev, data_groups[rank % space], space,
                    space_groups[rank // space], grid, backend)


def release() -> None:
    """Leave the process group (every rank calls this at the end)."""
    if dist.is_initialized():
        dist.destroy_process_group()
