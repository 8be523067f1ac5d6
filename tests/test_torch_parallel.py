"""The port's data-parallel step, checkpoints and eval over 2 ranks
(`ocrfdet_tpu_torch/parallel/`) against the JAX package on the CPU.

Two runs of `tests/torch_parallel_worker.py` in subprocesses, gloo on a
free localhost port, one intra-op thread a rank: 2 ranks, then 1 rank
resuming the 2-rank checkpoint. Meanwhile this process compiles JAX's
side on a 1 x 2 CPU mesh (the `data` axis): the raw averaged gradients,
losses and BatchNorm statistics of `parallel/step.py::build_train_step`'s
`local_grads` (its loss with `pmean` normalisers, then `_pmean_both`),
and `build_train_step` itself. Both packages take the tiny config of
`tests/test_torch_train_step.py` (stereo branch off, full learning rate,
no dropout), the same weights (JAX's init shapes with random values,
through the weight bridge) and the same global batch (seed 0, batch 4,
two samples a rank: each rank's train-mode BatchNorm then sees the
batch of that file's one-device step, whose tolerances rest on it).

JAX's data-parallel gradient is `data` times the gradient of the loss it
reports (the psum that shard_map's transpose puts on the replicated
parameters; pinned on a toy loss below), so its raw gradients are held
halved; the port averages the ranks' gradients, as DDP does.

Tolerances are `tests/test_torch_train_step.py`'s, for the same
reasons: the loss dict rtol 1e-3; the gradients a relative L2 error of
0.05 over all parameters and 0.25 per tensor (floored at 1e-3 of the
mean tensor norm; this config's gradient is chaotic in fp32); after the
step the parameters' and the EMA's change on the entries whose gradient
the packages agree on to 1% of the learning rate (of the EMA's own
move), every parameter to 2.5 learning rates, the BatchNorm statistics
and their EMA to rtol 1e-3 / atol 1e-5. AdamW's first moment is 0.1
times the clipped gradient and is held as the gradient is; the second,
quadratic in it, to twice the gradient's relative errors.
"""
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.data.synthetic import make_batch as jmake_batch
from ocrfdet_tpu.models.detector import OcRFDet as JaxOcRFDet
from ocrfdet_tpu.parallel.mesh import make_mesh
from ocrfdet_tpu.parallel.step import _pmean_both, build_train_step
from ocrfdet_tpu.train.optim import create_train_state, make_optimizer
from ocrfdet_tpu.train.trainstep import compute_losses as jcompute_losses
from ocrfdet_tpu.train.trainstep import total_loss as jtotal_loss
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch.data.fake_nuscenes import build_fake_nuscenes
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.parallel.step import ZeroLayout
from ocrfdet_tpu_torch.train import optim
from ocrfdet_tpu_torch.utils.weights import (conv_transpose_scopes,
                                             flax_to_state_dict,
                                             load_flax_variables)
from test_torch_train_step import STEPS_PER_EPOCH, _config, random_variables

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
# the global batch of the step held against JAX: 2 samples a rank, so
# that each rank's train-mode BatchNorm sees the batch of
# test_torch_train_step.py's one-device step
BATCH = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(mode, world, out_dir):
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=port, OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT))
        log = open(out_dir / f"{mode}_{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), mode, str(out_dir)], env=env,
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, out_dir, mode):
    for rank, (p, log) in enumerate(procs):
        rc = p.wait(timeout=900)
        log.close()
        if rc != 0:
            text = (out_dir / f"{mode}_{rank}.log").read_text()
            pytest.fail(f"{mode} rank {rank} exited {rc}:\n{text[-4000:]}")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _moments(opt_state, kind):
    """AdamW's `kind` ("mu" or "nu") tree of the render and other groups
    of JAX's optimizer state, merged into one parameter tree."""
    parts = opt_state[1].inner_states
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    trees = [getattr(parts[g].inner_state[0], kind)
             for g in ("render", "other")]
    return jax.tree.map(lambda a, b: b if masked(a) else a, *trees,
                        is_leaf=masked)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    jcfg, cfg = _config(jconfig), _config(tconfig)
    jm = JaxOcRFDet(jcfg)
    jb = jax.tree.map(jnp.asarray, jmake_batch(jcfg, batch_size=BATCH, seed=0))
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb,
                                       train=True))
    v = random_variables({"params": v["params"],
                          "batch_stats": v["batch_stats"]})
    model = load_flax_variables(OcRFDet(cfg, render_heads=True), v)
    scopes = conv_transpose_scopes(model)
    # the trainer and eval runs: the tiny config with ASPP dropout on
    tcfg = tconfig.tiny_config()
    tcfg = dataclasses.replace(tcfg, vt=dataclasses.replace(
        tcfg.vt, depthnet=dataclasses.replace(tcfg.vt.depthnet,
                                              aspp_dropout=0.1)))
    pkl = build_fake_nuscenes(str(out / "data"), tcfg, n_samples=4)
    torch.save(dict(step_cfg=cfg, weights=model.state_dict(), cfg=tcfg,
                    pkl=pkl, batch_size=BATCH), out / "inputs.pt")
    two = _launch("two", 2, out)

    # JAX: the raw averaged gradients of build_train_step's local_grads
    mesh = make_mesh(data=2, space=1, devices=jax.devices()[:2])
    specs = jax.tree.map(lambda x: P() if x.ndim == 0 else P("data"), jb)

    def local(params, batch_stats, batch):
        def loss_fn(p):
            (preds, aux), mut = jm.apply(
                {"params": p, "batch_stats": batch_stats}, batch,
                train=True, mutable=["batch_stats"])
            losses = jcompute_losses(
                jcfg, preds, aux, batch,
                mean_fn=lambda x: jax.lax.pmean(x, "data"))
            return jtotal_loss(losses), (losses, mut["batch_stats"])
        (loss, (losses, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return (_pmean_both(grads), _pmean_both(stats), _pmean_both(loss),
                _pmean_both(losses))
    jgrads, _, _, jlosses = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), P(), specs),
        out_specs=(P(), P(), P(), P())))(v["params"], v["batch_stats"], jb)
    _wait(two, out, "two")
    one = _launch("one", 1, out)
    tx = make_optimizer(jcfg.optim, v["params"], STEPS_PER_EPOCH)
    jstate, jmetrics = build_train_step(jcfg, jm, tx, mesh)(
        create_train_state(jax.tree.map(jnp.asarray, v), tx), jb)
    _wait(one, out, "one")

    def sd(params, stats=None):
        tree = {"params": _np(params)}
        if stats is not None:
            tree["batch_stats"] = _np(stats)
        return flax_to_state_dict(tree, scopes)
    return dict(
        cfg=cfg, variables=v, scopes=scopes, out=out,
        step=torch.load(out / "step.pt", weights_only=False),
        gather=torch.load(out / "gather.pt", weights_only=False),
        eval_two=torch.load(out / "eval_two.pt", weights_only=False),
        one=torch.load(out / "one.pt", weights_only=False),
        jgrads=sd(jgrads), jlosses=_np(jlosses), jmetrics=_np(jmetrics),
        jraw=sd(jstate.params, jstate.batch_stats),
        jema=sd(jstate.ema_params, jstate.ema_batch_stats),
        jmu=sd(_moments(jstate.opt_state, "mu")),
        jnu=sd(_moments(jstate.opt_state, "nu")), jstep=int(jstate.step))


def _rel_l2(got, want, overall, per_tensor):
    """The relative L2 error over all tensors <= overall, and each
    tensor's <= per_tensor of its norm (floored at 1e-3 of the mean
    tensor norm)."""
    assert set(got) == set(want)
    names = sorted(want)
    g = torch.cat([got[n].ravel() for n in names]).numpy()
    w = np.concatenate([want[n].numpy().ravel() for n in names])
    assert np.linalg.norm(g - w) <= overall * np.linalg.norm(w)
    floor = 1e-3 * np.mean([np.linalg.norm(want[n].numpy()) for n in names])
    for n in names:
        err = np.linalg.norm(got[n].numpy() - want[n].numpy())
        scale = max(np.linalg.norm(want[n].numpy()), floor)
        assert err <= per_tensor * scale, (n, err, scale)


def test_dp_losses_match_jax(run):
    got, want = run["step"]["losses"], run["jlosses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(run["step"]["metrics"]["loss_total"],
                               float(run["jmetrics"]["loss_total"]),
                               rtol=1e-3)


def test_jax_data_axis_gradient_is_data_times_the_loss_gradient():
    """The reference's caveat the next test divides out: under shard_map,
    `jax.value_and_grad` of each shard's loss with respect to the
    replicated parameters transposes their implicit broadcast into a
    psum, so `build_train_step`'s gradient is the SUM over the `data`
    shards of their losses' gradients, `data` times the gradient of the
    mean loss it reports (`_pmean_both` then averages equal values). On
    a toy loss with `local_grads`' pmean normaliser: the loss 2.5, its
    gradient 2.5, JAX's 5."""
    mesh = make_mesh(data=2, space=1, devices=jax.devices()[:2])

    def local(p, x):
        def loss(p):
            n = jax.lax.pmean(jnp.asarray(x.shape[0], jnp.float32), "data")
            return jnp.sum(p * x) / n
        value, grad = jax.value_and_grad(loss)(p)
        return _pmean_both(grad), _pmean_both(value)
    x = jnp.arange(1.0, 5.0).reshape(4, 1)
    grad, value = jax.jit(shard_map(local, mesh=mesh,
                                    in_specs=(P(), P("data")),
                                    out_specs=(P(), P())))(jnp.ones(1), x)
    assert float(value) == 2.5 == float(jnp.sum(x) / 4)
    assert float(grad[0]) == 2 * 2.5


def test_dp_raw_averaged_gradients_match_jax(run):
    """The gradients before AdamW, whose first step would hide a scale
    error (ocrfdet_tpu/parallel/collectives.py): the port averages the
    ranks' gradients (DDP's mean: the gradient of the mean loss both
    packages report), JAX's step carries the factor `data` = 2 of the
    test above, divided out here. (Its clip to norm 5 of gradients of
    norm ~3e4 takes the factor out before AdamW, so the moments and
    the parameters below compare as they are.)"""
    half = {k: v / 2 for k, v in run["jgrads"].items()}
    _rel_l2(run["step"]["grads"], half, 0.05, 0.25)


@pytest.mark.parametrize("kind", ["m", "v"])
def test_dp_gathered_moments_match_jax(run, kind):
    state = run["step"]["state"]["optimizer"]
    got = {k[2:]: t for k, t in state.items() if k.startswith(kind + ".")}
    want = run["jmu"] if kind == "m" else run["jnu"]
    norm = np.sqrt(sum(float((g.double() ** 2).sum())
                       for g in run["step"]["grads"].values()))
    assert norm > 10 * run["cfg"].optim.grad_clip_norm    # both clip
    tol = 1.0 if kind == "m" else 2.0
    _rel_l2(got, want, 0.05 * tol, 0.25 * tol)


def check_step_matches_jax(run, step, factor, bn_atol=1e-5):
    """Parameters, BatchNorm statistics (rtol 1e-3, `bn_atol`) and both
    EMA trees after one step, gathered from the ranks (`step`), against
    JAX's step (`run`'s jraw, jema and jstep), on the entries whose raw
    gradients (`run`'s jgrads, the ones JAX's step clips, divided by its
    gradient `factor`) the packages agree on; the step count."""
    st, cfg = step["state"], run["cfg"].optim
    assert st["step"] == run["jstep"] == 1
    assert step["metrics"]["skipped_nonfinite"] == 0.0
    assert float(run["jmetrics"]["skipped_nonfinite"]) == 0.0
    lr = optim.lr_at(cfg, 0)
    decay = optim.ema_decay(cfg, 0)
    init = flax_to_state_dict(run["variables"], run["scopes"])
    model, ema = st["model"], {**st["ema_params"], **st["ema_stats"]}
    render = {k for k in model if optim.is_render_param(k)}
    jnorm = np.sqrt(sum(float((g.numpy().astype(np.float64) ** 2).sum())
                        for g in run["jgrads"].values()))
    clip = min(1.0, cfg.grad_clip_norm / jnorm)
    n_checked = 0
    for k, want in run["jraw"].items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(model[k].numpy(), want.numpy(),
                                       rtol=1e-3, atol=bn_atol, err_msg=k)
            np.testing.assert_allclose(ema[k].numpy(), run["jema"][k].numpy(),
                                       rtol=1e-3, atol=bn_atol, err_msg=k)
            continue
        k_lr = lr * cfg.lr_mult_render if k in render else lr
        p0 = init[k].numpy()
        np.testing.assert_allclose(model[k].numpy(), want.numpy(), rtol=0,
                                   atol=2.5 * k_lr, err_msg=k)
        jg, tg = run["jgrads"][k].numpy() / factor, step["grads"][k].numpy()
        agree = ((np.abs(jg) * factor * clip > 1e-5)
                 & (np.abs(tg - jg) < 0.5 * np.abs(jg)))
        spacing = 2 * np.spacing(np.abs(p0) + 2.5 * k_lr)
        for got, wnt, size in ((model[k], want, k_lr),
                               (ema[k], run["jema"][k], (1 - decay) * k_lr)):
            d_got = (got.numpy() - p0)[agree]
            d_want = (wnt.numpy() - p0)[agree]
            np.testing.assert_array_less(np.abs(d_got - d_want),
                                         0.01 * size + spacing[agree],
                                         err_msg=k)
        n_checked += int(agree.sum())
    assert n_checked > 0.5 * sum(t.numel() for t in step["grads"].values())


def test_dp_step_matches_jax_step(run):
    """Parameters, BatchNorm statistics and both EMA trees after one
    step, gathered from the ranks; the step count."""
    check_step_matches_jax(run, run["step"], 2)     # see above


def test_zero_halves_each_ranks_moments_and_ema(run):
    """Each rank holds its half of every tensor with an even axis: about
    half of the moments' and EMAs' bytes (the tensors without one are
    replicated)."""
    held, whole = run["step"]["held"], run["step"]["whole"]
    assert len(held) == 2 and held[0] == held[1]
    assert 0.5 <= held[0] / whole < 0.51, (held, whole)


def test_zero_layout_follows_jax_zero_sharding():
    """The first axis of size >= n divisible by n, else replicated; the
    ranks' slices tile the tensor."""
    lay = ZeroLayout(2, 1)
    assert lay.axis((3, 8, 4)) == 1 and lay.axis((1, 1, 3)) is None
    assert lay.axis((2,)) == 0 and lay.axis(()) is None
    t = torch.arange(3 * 8 * 4).reshape(3, 8, 4)
    parts = [ZeroLayout(2, r).shard(t) for r in range(2)]
    assert torch.equal(torch.cat(parts, 1), t)
    assert ZeroLayout(4, 3).shard(torch.ones(1, 1, 3)).shape == (1, 1, 3)


def test_two_rank_checkpoint_resumes_on_one_rank_bitwise(run):
    """The 2-rank checkpoint holds the whole state; a 1-rank data-parallel
    trainer resumes it bit for bit and its next step gives the bits of a
    single-device trainer resumed from the same file."""
    one = run["one"]
    ckpt = torch.load(run["out"] / "train" / "ckpt_epoch_1.pt",
                      weights_only=False)
    dp, single = one["dp"], one["single"]
    assert dp["start"] == single["start"] == 2
    assert len(ckpt["generators"]) == 2
    res = dp["resumed"]
    assert res["step"] == ckpt["step"] == 1
    for part in ("model", "optimizer", "ema_params", "ema_stats"):
        assert set(res[part]) == set(ckpt[part])
        for k, t in ckpt[part].items():
            assert torch.equal(res[part][k], t), (part, k)
    assert torch.equal(res["generator"], ckpt["generators"][0])
    assert dp["metrics"] == single["metrics"]
    assert dp["metrics"][0]["skipped_nonfinite"] == 0.0
    for part in ("model", "optimizer", "ema_params", "ema_stats"):
        for k, t in single["state"][part].items():
            assert torch.equal(dp["state"][part][k], t), (part, k)


def test_two_rank_eval_gives_the_one_rank_metrics(run):
    two, one = run["eval_two"], run["one"]["eval_one"]
    assert set(two) == set(one) and "mAP" in one
    np.testing.assert_equal(two, one)


def test_gather_objects_round_trips(run):
    got = run["gather"]
    assert [g["rank"] for g in got] == [0, 1]
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["rows"], np.arange(r + 2))
