"""The data-parallel process group (counterpart of
ocrfdet_tpu/parallel/mesh.py).

The JAX package drives a (data, space) device mesh from one process.
The port runs one process per card (`torchrun`), and its `data` axis is
a `torch.distributed` process group: NCCL between cards, gloo between
CPU processes. Parameters are replicated; each data rank loads its
slice of every global batch. The JAX trainer takes
`data = min(devices // space, batch_size)` devices (its trainer.py);
here `space` is 1 (the `space` axis is ROADMAP item 13b) and a rank at
or past `data` holds no data and joins no collective of the group.

    torchrun --nproc-per-node 4 -m ocrfdet_tpu_torch.tools.train \
        --multihost --infos INFOS.pkl --work-dir work/ocrfdet
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataMesh:
    """This process's place on the data axis."""
    rank: int
    world: int
    data: int                  # ranks on the data axis: 0 .. data - 1
    device: torch.device
    group: Optional[object]    # the data ranks' process group

    @property
    def active(self) -> bool:
        """Whether this rank holds data (rank < data)."""
        return self.rank < self.data


def init_data_mesh(batch_size: int, device=None, space: int = 1) -> DataMesh:
    """Join the process group that `torchrun` describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    and build the data ranks' group, which every rank must create.
    `device` "cpu" runs gloo on the CPU; otherwise the rank's card
    `cuda:LOCAL_RANK` with NCCL (CUDA must be available)."""
    if space != 1:
        raise NotImplementedError(
            "the space axis (parallel.space_axis > 1) is ROADMAP item 13b")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is not None and torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        dev, backend = torch.device("cuda", local), "nccl"
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    data = min(world // space, batch_size)     # the JAX trainer's rule
    group = dist.new_group(list(range(data)))
    return DataMesh(rank, world, data, dev, group if rank < data else None)


def release() -> None:
    """Leave the process group (every rank calls this at the end)."""
    if dist.is_initialized():
        dist.destroy_process_group()
