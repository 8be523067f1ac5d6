"""One process of `tests/test_torch_space.py`'s runs on the `space` axis
(a helper, not a test module): gloo on the CPU, one intra-op thread, the
rank and the world from `torchrun`'s environment variables, which the
test sets.

    python tests/torch_space_worker.py halo DIR    # any world size S
    python tests/torch_space_worker.py two DIR     # 2 ranks: space 2
    python tests/torch_space_worker.py four DIR    # 4 ranks
    python tests/torch_space_worker.py one DIR     # 1 rank, after `four`

`halo` holds the primitives of parallel/{halo,collectives}.py on S
ranks against the full grid and writes DIR/halo_S_<rank>.pt (the checks
raise in the worker). `two` takes DIR/two_in.pt and writes, from rank
0, DIR/two.pt: the tiny OcRF eval forward with every phase on, the
BEV-row forwards (eval and train) of the 16-row LSS model, the raw
averaged gradients of the OcRF training model and one whole step's
gathered state. `four` takes DIR/four_in.pt and writes DIR/four.pt (the
BEV-row forwards of the 64-row LSS model over 4 ranks) and a `Trainer`
checkpoint of the 2 x 2 grid after one step on a fake nuScenes under
DIR/train/. `one` resumes that checkpoint on 1 rank and writes
DIR/one.pt.
"""
import copy
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ocrfdet_tpu_torch import entry  # noqa: E402
from ocrfdet_tpu_torch.data.dataset import Loader, NuScenesDataset  # noqa
from ocrfdet_tpu_torch.models.detector import OcRFDet  # noqa: E402
from ocrfdet_tpu_torch.models.norm import BatchNorm2d  # noqa: E402
from ocrfdet_tpu_torch.parallel import collectives as col  # noqa: E402
from ocrfdet_tpu_torch.parallel import halo as H  # noqa: E402
from ocrfdet_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from ocrfdet_tpu_torch.parallel import step as pstep  # noqa: E402
from ocrfdet_tpu_torch.train import step as tstep  # noqa: E402
from ocrfdet_tpu_torch.train.trainer import Trainer  # noqa: E402
from ocrfdet_tpu_torch.utils.weights import load_flax_variables  # noqa


def _save0(mesh, obj, path):
    if mesh.rank == 0:
        torch.save(obj, path)


# ----------------------------------------------------------- primitives
def halo(out_dir):
    world = int(os.environ["WORLD_SIZE"])
    mesh = pmesh.init_data_mesh(1, device="cpu", space=world)
    ax = mesh.space_axis
    S, s = ax.size, ax.index
    g = torch.Generator().manual_seed(0)
    Yl = 4
    X = torch.randn(2, 3, S * Yl, 5, generator=g)
    R = torch.randn(2, 3, S * Yl + 8, 5, generator=g)
    mine = slice(s * Yl, (s + 1) * Yl)
    report = {}

    # halo_exchange_rows: the padded full grid's rows, exactly; its
    # backward is the transpose: every rank's loss on its own extended
    # block, summed over the ranks, differentiated on the full grid
    for up, down in ((1, 1), (1, 0), (2, 2), (0, 1)):
        x = X[:, :, mine].clone().requires_grad_(True)
        y = H.halo_exchange_rows(x, ax, up, down)
        full = F.pad(X, (0, 0, up, down)).requires_grad_(False)
        want = full[:, :, s * Yl:s * Yl + up + Yl + down]
        assert torch.equal(y, want), (up, down)
        Xf = X.clone().requires_grad_(True)
        loss = sum((F.pad(Xf, (0, 0, up, down))[
            :, :, r * Yl:r * Yl + up + Yl + down]
            * R[:, :, r:r + up + Yl + down]).sum() for r in range(S))
        loss.backward()
        (y * R[:, :, s:s + up + Yl + down]).sum().backward()
        assert torch.equal(x.grad, Xf.grad[:, :, mine]), (up, down)
        report[f"halo{up}{down}"] = True

    # all_gather_cat and psum under a replicated loss: each block's
    # gradient is S times its partial (the step's mean divides by S)
    # (multiples of 1/8: their sums are exact in any order)
    Xq = torch.round(X * 8) / 8
    x = Xq[:, :, mine].clone().requires_grad_(True)
    gathered = col.all_gather_cat(x, ax, 2)
    assert torch.equal(gathered, Xq)
    summed = col.psum(x * 2.0, ax)
    assert torch.equal(summed, 2.0 * sum(Xq[:, :, r * Yl:(r + 1) * Yl]
                                         for r in range(S)))
    loss = (gathered * R[:, :, :S * Yl]).sum() + (summed * R[:, :, :Yl]).sum()
    loss.backward()
    want = S * R[:, :, mine] + 2.0 * (S * R[:, :, :Yl])
    assert torch.equal(x.grad, want), "gather/psum transposes"
    assert torch.equal(H.slice_rows(Xq, ax), Xq[:, :, mine])
    report["gather_psum"] = True

    # the blocked ops against the full grid within fp32 rounding: a
    # stride-1 and a stride-2 ConvBN (train-mode BatchNorm with the
    # grid's statistics), a 3x3 conv with bias, the row and column
    # upsampling; their gradients (each rank's / S) against autograd on
    # the full grid
    from ocrfdet_tpu_torch.models.resnet import ConvBN
    torch.manual_seed(1)
    c1, c2 = ConvBN(3, 4, 3, 1), ConvBN(4, 4, 3, 2)
    head = torch.nn.Conv2d(4, 2, 3, padding=1)
    for m in (c1, c2):
        m.BatchNorm_0.weight.data.uniform_(0.5, 1.5)
        m.BatchNorm_0.bias.data.normal_()
    mods = [c1, c2, head]

    def net(x, halo):
        y = c2(c1(x, halo), halo)
        if halo is None:
            y = head(y)
            y = F.interpolate(y, size=(y.shape[2] * 4, y.shape[3] * 3),
                              mode="bilinear", align_corners=True)
        else:
            y = F.conv2d(H.halo_exchange_rows(y, halo, 1, 1), head.weight,
                         head.bias, 1, (0, 1))
            y = H.resize_rows_blocked(H.resize_cols(y, y.shape[3] * 3),
                                      y.shape[2] * 4 * halo.size, halo)
        return y
    base = [copy.deepcopy(m.state_dict()) for m in mods]
    Xf = X.clone().requires_grad_(True)
    ref = net(Xf, None)
    Rr = torch.randn(ref.shape, generator=g)
    (ref * Rr).sum().backward()
    ref_grads = [p.grad.clone() for m in mods for p in m.parameters()]
    stats_ref = [b.clone() for m in (c1, c2)
                 for b in (m.BatchNorm_0.running_mean,
                           m.BatchNorm_0.running_var)]
    for m, sd in zip(mods, base):
        m.load_state_dict(sd)
        m.zero_grad()
    x = X[:, :, mine].clone().requires_grad_(True)
    out = net(x, ax)
    n = out.shape[2]
    assert torch.allclose(out, ref[:, :, s * n:(s + 1) * n], rtol=1e-5,
                          atol=1e-6), float((out - ref[:, :, s * n:(s + 1)
                                                      * n]).abs().max())
    full_out = col.all_gather_cat(out, ax, 2)
    (full_out * Rr).sum().backward()
    assert torch.allclose(x.grad / S, Xf.grad[:, :, mine], rtol=1e-4,
                          atol=1e-6)
    grads = [p.grad for m in mods for p in m.parameters()]
    for got, want in zip(grads, ref_grads):
        # the step's mean over the ranks of each rank's gradient
        mean = col.all_reduce_sum(got, ax) / S
        assert torch.allclose(mean, want, rtol=1e-4, atol=1e-5)
    for got, want in zip([b for m in (c1, c2)
                          for b in (m.BatchNorm_0.running_mean,
                                    m.BatchNorm_0.running_var)], stats_ref):
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    report["blocked_ops"] = True
    torch.save(report, os.path.join(out_dir, f"halo_{S}_{mesh.rank}.pt"))
    pmesh.release()


# ------------------------------------------------------------- models
def _model(cfg, variables, axis, train):
    model = load_flax_variables(OcRFDet(cfg, render_heads=cfg.with_ocrf),
                                variables)
    model.set_space(axis)
    return model.train(train)


def _bn_stats(model):
    return {n + "." + k: getattr(m, k).clone()
            for n, m in model.named_modules() if isinstance(m, BatchNorm2d)
            for k in ("running_mean", "running_var")}


def bev_rows(case, axis):
    """The LSS model on BEV row blocks: eval predictions, then one
    train-mode forward's predictions and BatchNorm statistics."""
    batch = entry.to_device(case["batch"], "cpu")
    out = {}
    with torch.no_grad():
        for train in (False, True):
            model = _model(case["cfg"], case["variables"], axis, train)
            preds, _ = model(batch)
            out["train" if train else "eval"] = [
                {k: v.clone() for k, v in t.items()} for t in preds]
            if train:
                out["stats"] = _bn_stats(model)
    return out


def ocrf_eval(case, axis):
    batch = entry.to_device(case["batch"], "cpu")
    with torch.no_grad():
        preds, aux = _model(case["cfg"], case["variables"], axis,
                            False)(batch)
    return dict(preds=[{k: v.clone() for k, v in t.items()} for t in preds],
                aux={k: v.clone() for k, v in aux.items()})


def ocrf_grads(case, mesh):
    """The raw averaged gradients and the losses of one forward and
    backward on the grid, then one whole step from fresh weights."""
    cfg, batch = case["cfg"], entry.to_device(case["batch"], "cpu")
    model = load_flax_variables(OcRFDet(cfg, render_heads=True),
                                case["variables"])
    state = pstep.DataParallelState(cfg, model, mesh, steps_per_epoch=100)
    grads, losses = tstep.forward_backward(state, batch)
    names = state.optimizer.names["render"] + state.optimizer.names["other"]
    raw = {n: g.clone() for n, g in zip(names, grads)}
    losses = {k: float(v) for k, v in losses.items()}
    model = load_flax_variables(OcRFDet(cfg, render_heads=True),
                                case["variables"])
    state = pstep.DataParallelState(cfg, model, mesh, steps_per_epoch=100)
    col.STATS.clear()
    metrics = tstep.train_step(state, batch)
    counts = dict(col.STATS)
    return dict(grads=raw, losses=losses, metrics=metrics,
                state=state.state_dict(), collectives=counts)


def two(out_dir):
    inp = torch.load(os.path.join(out_dir, "two_in.pt"), weights_only=False)
    mesh = pmesh.init_data_mesh(1, device="cpu", space=2)
    assert (mesh.world, mesh.data, mesh.space, mesh.s) == (2, 1, 2,
                                                           mesh.rank)
    out = dict(ocrf_eval=ocrf_eval(inp["ocrf_eval"], mesh.space_axis),
               bev=bev_rows(inp["bev"], mesh.space_axis),
               step=ocrf_grads(inp["step"], mesh))
    _save0(mesh, out, os.path.join(out_dir, "two.pt"))
    pmesh.release()


def _fake_nuscenes(inp, batch_size, mesh, is_train):
    ds = NuScenesDataset(inp["cfg"], inp["pkl"], is_train=is_train,
                         cbgs=False)
    return Loader(ds, batch_size, shuffle=is_train, drop_last=is_train,
                  num_workers=1, process_index=mesh.d if mesh else 0,
                  process_count=mesh.data if mesh else 1)


def four(out_dir):
    inp = torch.load(os.path.join(out_dir, "four_in.pt"), weights_only=False)
    # the 64-row model on 4 space ranks
    mesh = pmesh.init_data_mesh(1, device="cpu", space=4)
    assert (mesh.data, mesh.space) == (1, 4)
    _save0(mesh, bev_rows(inp["bev"], mesh.space_axis),
           os.path.join(out_dir, "four.pt"))
    # the trainer on the 2 x 2 grid: rows of every batch by data index,
    # the cameras by space index; one step of epoch 1, then a checkpoint
    cfg = inp["cfg"]
    mesh2 = pmesh.init_data_mesh(cfg.batch_size, device="cpu", space=2)
    assert (mesh2.data, mesh2.space, mesh2.d, mesh2.s) == (
        2, 2, mesh2.rank // 2, mesh2.rank % 2)
    trainer = Trainer(cfg, os.path.join(out_dir, "train"), 2, mesh=mesh2)
    trainer.init_state()
    stats = trainer.run_epoch(_fake_nuscenes(inp, 2, mesh2, True), 1,
                              max_steps=1, log_every=1)
    trainer.save(1)
    _save0(mesh2, stats.metrics, os.path.join(out_dir, "four_metrics.pt"))
    pmesh.release()


def one(out_dir):
    inp = torch.load(os.path.join(out_dir, "four_in.pt"), weights_only=False)
    cfg = inp["cfg1"]            # the same config at space 1
    mesh = pmesh.init_data_mesh(batch_size=2, device="cpu")
    loader = _fake_nuscenes(dict(inp, cfg=cfg), 2, None, True)
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
    torch.save(runs, os.path.join(out_dir, "one.pt"))
    pmesh.release()


if __name__ == "__main__":
    torch.set_num_threads(1)
    np.seterr(all="ignore")
    {"halo": halo, "two": two, "four": four, "one": one}[sys.argv[1]](
        sys.argv[2])
