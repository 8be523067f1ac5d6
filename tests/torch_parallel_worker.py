"""One process of `tests/test_torch_parallel.py`'s data-parallel runs (a
helper, not a test module): gloo on the CPU, one intra-op thread, the
rank and the group from `torchrun`'s environment variables, which the
test sets.

    python tests/torch_parallel_worker.py two DIR   # 2 ranks
    python tests/torch_parallel_worker.py one DIR   # 1 rank, after `two`

`two` (world size 2) takes DIR/inputs.pt (the config, the weights and
the fake nuScenes info file of the test) and writes, from rank 0:
  * step.pt: one data-parallel step of the tiny config on the global
    synthetic batch (seed 0, the test's batch size): the raw averaged
    gradients, the averaged losses, the metrics, the gathered state, and
    each rank's bytes of moments and EMA against the whole state's;
  * gather.pt: `gather_objects` of one object a rank;
  * train/: a `Trainer` checkpoint after one step of epoch 1 on the fake
    nuScenes (ASPP dropout on);
  * eval_two.pt: `run_eval` of that state's EMA over the eval set, each
    rank evaluating its rows of every batch of 2.
`one` (world size 1) writes one.pt: the 2-rank checkpoint resumed by a
data-parallel `Trainer` (its state as resumed, then after one step of
epoch 2) and by a single-device `Trainer` (after the same step), and
`run_eval` of the checkpoint's EMA at batch 1 without a process group.
"""
import copy
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ocrfdet_tpu_torch import entry  # noqa: E402
from ocrfdet_tpu_torch.data.dataset import Loader, NuScenesDataset  # noqa
from ocrfdet_tpu_torch.models.detector import OcRFDet  # noqa: E402
from ocrfdet_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from ocrfdet_tpu_torch.parallel import step as pstep  # noqa: E402
from ocrfdet_tpu_torch.parallel.multihost import gather_objects  # noqa
from ocrfdet_tpu_torch.train import step as tstep  # noqa: E402
from ocrfdet_tpu_torch.train.evaluate import ema_detector, run_eval  # noqa
from ocrfdet_tpu_torch.train.trainer import Trainer  # noqa: E402


def rank_rows(batch, mesh):
    """This rank's rows of a global batch: every tensor whose first axis
    is the batch's (and each per-task list of targets) cut in `data`
    equal parts; `with_prev` and `use_box_mask` are shared."""
    B = batch["imgs"].shape[0]
    n = B // mesh.data

    def rows(v):
        if isinstance(v, list):
            return [rows(t) for t in v]
        if v.dim() == 0 or v.shape[0] != B:
            return v
        return v[mesh.rank * n:(mesh.rank + 1) * n]
    return {k: rows(v) for k, v in batch.items()}


def _step(inp, mesh, out_dir):
    cfg = inp["step_cfg"]
    model = OcRFDet(cfg, render_heads=True)
    model.load_state_dict(inp["weights"], strict=True)
    state = pstep.DataParallelState(cfg, model, mesh, steps_per_epoch=100)
    batch = entry.make_batch(cfg, seed=0, batch_size=inp["batch_size"],
                             device="cpu", with_targets=True)
    grads, losses = tstep.forward_backward(state, rank_rows(batch, mesh))
    names = state.optimizer.names["render"] + state.optimizer.names["other"]
    raw = {n: g.clone() for n, g in zip(names, grads)}
    loss = losses.pop("loss_total")
    metrics = tstep.apply_update(state, grads, dict(losses, loss_total=loss))

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    held = nbytes(state.optimizer.state_tensors() + state.ema_params.ema
                  + state.ema_stats.ema)
    sd = state.state_dict()
    whole = nbytes(list(sd["optimizer"].values())
                   + list(sd["ema_params"].values())
                   + list(sd["ema_stats"].values()))
    held = gather_objects(held, mesh.group)
    if mesh.rank == 0:
        torch.save(dict(grads=raw, losses={k: float(v) for k, v in
                                           losses.items()},
                        loss=float(loss), metrics=metrics, state=sd,
                        held=held, whole=whole),
                   os.path.join(out_dir, "step.pt"))


def _fake_nuscenes(inp, batch_size, mesh, is_train):
    cfg = inp["cfg"]
    ds = NuScenesDataset(cfg, inp["pkl"], is_train=is_train, cbgs=False)
    return Loader(ds, batch_size, shuffle=is_train, drop_last=is_train,
                  num_workers=1,
                  process_index=mesh.rank if mesh else 0,
                  process_count=mesh.data if mesh else 1)


def two(out_dir):
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    mesh = pmesh.init_data_mesh(batch_size=inp["batch_size"], device="cpu")
    assert (mesh.world, mesh.data, mesh.active) == (2, 2, True)
    _step(inp, mesh, out_dir)
    got = gather_objects({"rank": mesh.rank,
                          "rows": np.arange(mesh.rank + 2)}, mesh.group)
    if mesh.rank == 0:
        torch.save(got, os.path.join(out_dir, "gather.pt"))
    trainer = Trainer(inp["cfg"], os.path.join(out_dir, "train"), 2,
                      mesh=mesh)
    trainer.init_state()
    trainer.run_epoch(_fake_nuscenes(inp, 2, mesh, True), 1, max_steps=1,
                      log_every=1)
    trainer.save(1)
    metrics = run_eval(inp["cfg"], ema_detector(inp["cfg"], trainer.state,
                                                mesh.device),
                       _fake_nuscenes(inp, 2, mesh, False), mesh=mesh)
    if mesh.rank == 0:
        torch.save(metrics, os.path.join(out_dir, "eval_two.pt"))
    pmesh.release()


def one(out_dir):
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    cfg = inp["cfg"]
    mesh = pmesh.init_data_mesh(batch_size=2, device="cpu")
    assert (mesh.world, mesh.data) == (1, 1)
    loader = _fake_nuscenes(inp, 2, None, True)
    runs = {}
    for name, m in (("dp", mesh), ("single", None)):
        t = Trainer(cfg, os.path.join(out_dir, "train"), 2, device="cpu",
                    mesh=m)
        t.init_state()
        start = t.resume()
        # a copy: the state dict's tensors are the live ones
        resumed = copy.deepcopy(t.state.state_dict()) if m else None
        stats = t.run_epoch(loader, start, max_steps=1, log_every=1)
        runs[name] = dict(start=start, resumed=resumed,
                          metrics=stats.metrics, state=t.state.state_dict())
    ckpt = torch.load(os.path.join(out_dir, "train", "ckpt_epoch_1.pt"),
                      weights_only=False)
    runs["eval_one"] = run_eval(cfg, ema_detector(cfg, ckpt, "cpu"),
                                _fake_nuscenes(inp, 1, None, False))
    torch.save(runs, os.path.join(out_dir, "one.pt"))
    pmesh.release()


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"two": two, "one": one}[sys.argv[1]](sys.argv[2])
