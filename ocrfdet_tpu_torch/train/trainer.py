"""Training loop: epochs, the reference's hook gates, checkpoints and the
metrics log (counterpart of ocrfdet_tpu/train/trainer.py), on one device
or, with a `mesh` (`parallel/mesh.py`), as one rank of a data-parallel
run, split over the `space` axis where the config says so
(`parallel/step.py`'s state and collectives).

  * SequentialControlHook -> `with_prev` 0 before
    `optim.temporal_start_epoch`;
  * the render loss's box mask from epoch 2 on;
  * MEGVIIEMAHook -> the EMA inside `train_step`; a checkpoint holds the
    raw and the EMA weights;
  * CheckpointHook -> `torch.save` of the whole `TrainState` per epoch
    (GeoEnhDet's frozen teacher included, as the JAX package's),
    `latest.json` naming the newest, and `resume()`; in a data-parallel
    run every rank gathers the whole state and rank 0 writes it, so a
    checkpoint resumes on any number of ranks;
  * GeoEnhDet with `vggt_teacher.ckpt_path`: the released VGGT weights
    grafted onto the teacher at `init_state`.

The loader's threads decode and augment on the host; every CUDA call
(the copy to the card included) happens on the thread that iterates.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .. import entry
from ..config import OcRFDetConfig

# loader outputs that never go to the device (host-side evaluation only)
HOST_ONLY_KEYS = ("gt_boxes", "gt_labels", "sample_token")


def device_batch(batch: Dict, with_prev: float, use_box_mask: float,
                 device) -> Dict:
    """The loader's batch without its host-only entries, every array
    (and each per-task list of targets) on `device`, and the two
    epoch-gate scalars."""
    out = entry.to_device({k: v for k, v in batch.items()
                           if k not in HOST_ONLY_KEYS}, device)
    out["with_prev"] = torch.tensor(with_prev, dtype=torch.float32,
                                    device=device)
    out["use_box_mask"] = torch.tensor(use_box_mask, dtype=torch.float32,
                                       device=device)
    return out


@dataclass
class EpochStats:
    """One `run_epoch`: host-clock seconds per step of waiting on the
    loader (`wait_s`) and of the step itself, from the batch's copy to
    the card to the guard's host read (`step_s`), and each step's
    metrics."""
    epoch: int
    wall_s: float = 0.0
    wait_s: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)
    metrics: List[Dict[str, float]] = field(default_factory=list)

    @property
    def steps(self) -> int:
        return len(self.step_s)


class Trainer:
    def __init__(self, cfg: OcRFDetConfig, work_dir: str,
                 steps_per_epoch: int, device=None, mesh=None):
        """`steps_per_epoch` is `len(loader)`: the render learning rate
        decays by epoch. `device` defaults to "cuda", which must exist;
        with `mesh` (a data rank, whose loader yields its rows of each
        batch) it is the mesh's device."""
        self.cfg = cfg
        self.work_dir = work_dir
        self.mesh = mesh
        self.device = (entry.resolve_device(device) if mesh is None
                       else mesh.device)
        os.makedirs(work_dir, exist_ok=True)
        self.steps_per_epoch = steps_per_epoch
        self.state: Optional[entry.TrainState] = None

    def init_state(self):
        """The seeded training model (render heads on), AdamW, EMA; with
        a teacher checkpoint, its weights in the frozen teacher."""
        t0 = time.perf_counter()
        if self.mesh is None:
            self.state = entry.build_trainer(
                self.cfg, self.device, seed=self.cfg.seed,
                steps_per_epoch=self.steps_per_epoch)
        else:
            from ..parallel import step as dp
            self.state = dp.build_trainer(
                self.cfg, self.mesh, seed=self.cfg.seed,
                steps_per_epoch=self.steps_per_epoch)
        tcfg = self.cfg.vggt_teacher
        if tcfg is not None and tcfg.ckpt_path:
            from ..models.vggt import load_torch_weights
            load_torch_weights(self.state.model.aggregator, tcfg.ckpt_path)
            print(f"loaded VGGT teacher weights from {tcfg.ckpt_path}")
        n_params = sum(p.numel() for p in self.state.model.parameters())
        print(f"model parameters: {n_params / 1e6:.2f}M (built in "
              f"{time.perf_counter() - t0:.1f} s)")

    # -------------------------------------------------- checkpointing
    def save(self, epoch: int):
        """Write the whole state (every rank of the grid calls this; rank
        0, at (d, s) = (0, 0), writes)."""
        path = os.path.abspath(
            os.path.join(self.work_dir, f"ckpt_epoch_{epoch}.pt"))
        t0 = time.perf_counter()
        sd = self.state.state_dict()
        if self.mesh is None or self.mesh.rank == 0:
            torch.save(sd, path)
            with open(os.path.join(self.work_dir, "latest.json"), "w") as f:
                json.dump({"epoch": epoch, "path": path}, f)
            print(f"saved {path} ({os.path.getsize(path) / 1e9:.3f} GB in "
                  f"{time.perf_counter() - t0:.1f} s)")
        if self.mesh is not None:
            dist.barrier(self.mesh.grid)

    def resume(self) -> int:
        """Load the checkpoint `latest.json` names into the state; the
        epoch to start from (0 without a checkpoint)."""
        latest = os.path.join(self.work_dir, "latest.json")
        if not os.path.exists(latest):
            return 0
        with open(latest) as f:
            meta = json.load(f)
        self.state.load_state_dict(
            torch.load(meta["path"], map_location=self.device))
        return meta["epoch"] + 1

    # -------------------------------------------------------- running
    def epoch_flags(self, epoch: int):
        with_prev = 0.0 if epoch < self.cfg.optim.temporal_start_epoch \
            else 1.0
        use_box_mask = 1.0 if epoch >= 2 else 0.0
        return with_prev, use_box_mask

    def run_epoch(self, loader, epoch: int, log_every: int = 50,
                  max_steps: Optional[int] = None) -> EpochStats:
        with_prev, use_box_mask = self.epoch_flags(epoch)
        stats = EpochStats(epoch)
        log_path = os.path.join(self.work_dir, "metrics.jsonl")
        t0 = time.perf_counter()
        batches = loader.epoch(epoch)
        try:
            for i in range(len(loader) if max_steps is None
                           else min(max_steps, len(loader))):
                t = time.perf_counter()
                batch = next(batches)
                t_got = time.perf_counter()
                dev = device_batch(batch, with_prev, use_box_mask,
                                   self.device)
                vals = entry.train_step(self.state, dev)
                stats.wait_s.append(t_got - t)
                stats.step_s.append(time.perf_counter() - t_got)
                stats.metrics.append(vals)
                if i % log_every == 0 and (self.mesh is None
                                           or self.mesh.rank == 0):
                    dt = time.perf_counter() - t0
                    fps = (i + 1) * self.cfg.batch_size / max(dt, 1e-9)
                    parts = " ".join(
                        f"{k}={v:.3f}" for k, v in sorted(vals.items())
                        if k.startswith("loss"))
                    print(f"epoch {epoch} iter {i}: {parts} "
                          f"({fps:.2f} frames/s)", flush=True)
                    with open(log_path, "a") as f:
                        f.write(json.dumps(dict(
                            epoch=epoch, iter=i, frames_per_s=fps,
                            loader_wait_s=stats.wait_s[-1],
                            step_s=stats.step_s[-1], **vals)) + "\n")
        finally:
            batches.close()
        stats.wall_s = time.perf_counter() - t0
        return stats

    def fit(self, loader, start_epoch: int = 0,
            max_steps_per_epoch: Optional[int] = None):
        for epoch in range(start_epoch, self.cfg.optim.max_epochs):
            self.run_epoch(loader, epoch, max_steps=max_steps_per_epoch)
            self.save(epoch)
