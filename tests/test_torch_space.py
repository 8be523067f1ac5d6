"""The port's `space` axis (`ocrfdet_tpu_torch/parallel/{collectives,halo,
mesh,step}.py`, the detector's camera blocks, BEV row blocks and render
bands) against the port's own single rank and the JAX package's
shard_map on a `data x space` CPU mesh.

Runs of `tests/torch_space_worker.py` in subprocesses, gloo on a free
localhost port, one intra-op thread a rank (this process too, for the
single-rank references): the halo primitives on 2, 3 and 4 ranks; then,
side by side, 2 ranks (space 2) and 4 ranks (the 64-row BEV model at
space 4, and a trainer on the 2 x 2 grid), while JAX compiles its 1 x S
programs in threads (its train step once: a capturing optimizer hands
back the raw averaged gradients); then 1 rank resuming the 2 x 2
checkpoint. Both packages take the same weights (JAX's init shapes with
random values, through the weight bridge) and the same numpy batches
(JAX's `make_batch`), with the depth net's stereo branch off: JAX's CPU
cost volume interpolates in bf16 (ROADMAP section 3).

Tolerances, with what they rest on (an atol "of the scale" is a
multiple of max(1, the output's largest magnitude)):
  * the halo primitives (halo exchange, gather, psum, their backwards)
    exactly; the blocked convs, BatchNorm and upsampling within fp32
    rounding (worker);
  * the tiny OcRF eval forward at space 2 (every phase on) to JAX's
    space mesh at JAX's own bound, rtol 2e-3 / atol 2e-4
    (tests/test_parallel.py::test_deep_camera_sharding_ocrf_eval_matches),
    and to the port's single rank at 1e-5 of each output's scale (its
    cross-camera sums add in another order);
  * the BEV row blocks at space 2 (16 rows) and 4 (64 rows), without
    camera sharding, to the port's single rank at JAX's bounds for its
    sharded rows against its replicated ones
    (test_parallel.py::test_bev_row_sharding_matches_replicated): eval
    rtol 1e-4 / atol 1e-5 of the scale, train-mode predictions rtol
    1e-3 / atol 5e-4 of the scale (train-mode BatchNorm amplifies the
    rounding of the row blocks' sums: measured 3.5e-4 of the scale at
    S = 4), BatchNorm statistics rtol 1e-3 / atol 1e-4; to JAX's
    sharded forward at the packages' bounds for the unsharded model,
    eval rtol 1e-4 / atol 1e-4 of the scale (test_torch_slice.py),
    train rtol 1e-3 / atol 1e-3 of the scale (test_torch_geoenh.py's
    train-mode outputs), the statistics as above;
  * the raw averaged gradients at space 2 with every camera duplicated
    from camera 0 (so that each rank's image-backbone BatchNorm sees
    the whole batch's statistics): JAX's metric, the pooled
    least-squares scale sum(a.b)/sum(a.a) within 0.9-1.1 and the cosine
    above 0.95 per top-level module (the render heads apart), against
    the port's single rank and JAX's raw space-mesh gradients, whose
    factor is 1 (test_parallel.py::
    test_deep_camera_sharding_raw_gradients_match). Elementwise the
    tiny step's gradient is chaotic in fp32 (test_torch_train_step.py),
    and a sharded image backbone normalises each camera block's
    gradient on its own, as JAX's does. The losses to the single rank
    at rtol 1e-3, to JAX's space mesh at rtol 1e-2: JAX's own space
    mesh moves task0.loss_whl by 5e-3 from its single device here;
  * one step's parameters, EMAs and BatchNorm statistics on the 1 x 2
    grid to JAX's `build_train_step` with test_torch_parallel.py's
    tolerances, the statistics at atol 2e-4 (the packages' unsharded
    models differ by up to 1.3e-4 in them on this batch, measured) and
    to the port's single rank at rtol 1e-3 / atol 1e-5; the gathered
    moments (the first, and the second's square root) as the gradients
    are held, with a relative L2 error of 0.05 over all tensors;
  * the 2 x 2 grid's checkpoint resumed on 1 rank bit for bit.
"""
import dataclasses
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
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
from ocrfdet_tpu.parallel.step import build_train_step
from ocrfdet_tpu.train.optim import create_train_state, make_optimizer
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.data.fake_nuscenes import build_fake_nuscenes
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.models.norm import BatchNorm2d
from ocrfdet_tpu_torch.train import optim
from ocrfdet_tpu_torch.train import step as tstep
from ocrfdet_tpu_torch.utils.weights import (conv_transpose_scopes,
                                             flax_to_state_dict,
                                             load_flax_variables)
from test_torch_parallel import _moments, check_step_matches_jax
from test_torch_train_step import STEPS_PER_EPOCH, _config, random_variables

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_space_worker.py"


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
        log = open(out_dir / f"{mode}_{world}_{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), mode, str(out_dir)], env=env,
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, out_dir, mode, world):
    for rank, (p, log) in enumerate(procs):
        rc = p.wait(timeout=900)
        log.close()
        if rc != 0:
            text = (out_dir / f"{mode}_{world}_{rank}.log").read_text()
            pytest.fail(f"{mode} rank {rank} of {world} exited {rc}:\n"
                        f"{text[-4000:]}")


def _space(cfg, S, **kw):
    return dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, space_axis=S, **kw))


def _bev_config(mod, rows):
    """The tiny LSS model (stereo off) on a rows x rows BEV grid, the
    cell scaled as JAX's test_parallel.py::_tiny_bev does."""
    base = dataclasses.replace(_config(mod), with_ocrf=False)
    if rows == base.vt.bev_h:
        return base
    cell = 102.4 / rows
    return dataclasses.replace(
        base,
        grid=dataclasses.replace(base.grid, x=(-51.2, 51.2, cell),
                                 y=(-51.2, 51.2, cell)),
        vt=dataclasses.replace(base.vt, bev_h=rows, bev_w=rows),
        head=dataclasses.replace(base.head,
                                 voxel_size=(cell / 8, cell / 8)))


def _duplicated_cameras(batch, N):
    """Camera 0 copied over the camera axis of every per-camera array
    (JAX's test_parallel.py rule), and render camera 0."""
    batch = dict(batch)
    for k, v in batch.items():
        if not isinstance(v, np.ndarray) or v.ndim < 2:
            continue
        if v.ndim >= 3 and v.shape[2] == N and k != "gt_boxes":
            batch[k] = np.repeat(v[:, :, :1], N, axis=2)
        elif v.shape[1] == N and k not in ("kd_pair",):
            batch[k] = np.repeat(v[:, :1], N, axis=1)
    batch["render_cam"] = np.zeros_like(batch["render_cam"])
    return batch


def _variables(jcfg, batch, seed=0):
    jm = JaxOcRFDet(jcfg)
    v = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, batch), train=True))
    return random_variables({"params": v["params"],
                             "batch_stats": v["batch_stats"]}, seed)


def _jax_mesh(S, data=1):
    return make_mesh(data=data, space=S, devices=jax.devices()[:data * S])


def _jax_forwards(jcfg, v, batch, S, train):
    """JAX's forward on a 1 x S mesh: eval predictions and aux, and with
    `train` one train-mode forward's predictions and BatchNorm
    statistics (space rank 0's)."""
    jm = JaxOcRFDet(jcfg)

    def local(params, bstats, b):
        out = jm.apply({"params": params, "batch_stats": bstats}, b,
                       train=False)
        if train:
            (preds, _), mut = jm.apply(
                {"params": params, "batch_stats": bstats}, b, train=True,
                mutable=["batch_stats"])
            out = (out, preds, mut["batch_stats"])
        return out
    return jax.jit(shard_map(local, mesh=_jax_mesh(S),
                             in_specs=(P(), P(), P()), out_specs=P(),
                             check_vma=False))(
        v["params"], v["batch_stats"], jax.tree.map(jnp.asarray, batch))


def _capturing(tx):
    """`tx` after a transformation whose state is the gradients it is
    given: the step's raw averaged gradients, before the clip, come back
    in `opt_state[0]` of the state `build_train_step` returns (one JAX
    compile for the step and its gradients)."""
    capture = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(capture, tx)


def _jax_step(jcfg, v, batch, S):
    """`build_train_step` on a 1 x S mesh: (state, metrics), the raw
    averaged gradients in `state.opt_state[0]`."""
    tx = _capturing(make_optimizer(jcfg.optim, v["params"],
                                   STEPS_PER_EPOCH))
    return build_train_step(jcfg, JaxOcRFDet(jcfg), tx, _jax_mesh(S))(
        create_train_state(jax.tree.map(jnp.asarray, v), tx),
        jax.tree.map(jnp.asarray, batch))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _preds(preds):
    return [{k: np.asarray(t) for k, t in task.items()} for task in preds]


def _bn_stats(model):
    return {n + "." + k: getattr(m, k).clone()
            for n, m in model.named_modules() if isinstance(m, BatchNorm2d)
            for k in ("running_mean", "running_var")}


def _single_forwards(cfg, v, batch, train):
    """The port's single rank: eval predictions and aux, and with
    `train` one train-mode forward's predictions and BatchNorm
    statistics."""
    tb = entry.to_device(batch, "cpu")
    out = {}
    with torch.no_grad():
        for mode in (False, True) if train else (False,):
            model = load_flax_variables(
                OcRFDet(cfg, render_heads=cfg.with_ocrf), v).train(mode)
            preds, aux = model(tb)
            out["train" if mode else "eval"] = [
                {k: t.clone() for k, t in task.items()} for task in preds]
            if mode:
                out["stats"] = _bn_stats(model)
            else:
                out["aux"] = {k: t.clone() for k, t in aux.items()}
    return out


def _single_grads(cfg, v, batch):
    """The port's single rank: the gradients, the losses and the
    BatchNorm statistics after the forward."""
    model = load_flax_variables(OcRFDet(cfg, render_heads=True), v)
    state = tstep.TrainState(cfg, model, STEPS_PER_EPOCH)
    grads, losses = tstep.forward_backward(state, entry.to_device(batch,
                                                                  "cpu"))
    names = state.optimizer.names["render"] + state.optimizer.names["other"]
    return ({n: g.clone() for n, g in zip(names, grads)},
            {k: float(t) for k, t in losses.items()}, _bn_stats(model))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("space")
    # the 2-rank inputs: the OcRF model at space 2 (eval, gradients and
    # one step on duplicated cameras) and the 16-row LSS model
    jcfg, cfg = _config(jconfig), _config(tconfig)
    jcfg2, cfg2 = (_space(c, 2, shard_cameras=True) for c in (jcfg, cfg))
    eval_batch = jmake_batch(jcfg, batch_size=2, seed=3)
    step_batch = _duplicated_cameras(jmake_batch(jcfg, batch_size=2, seed=5),
                                     jcfg.data.num_cams)
    v = _variables(jcfg, eval_batch)
    bev = {}
    for S, rows in ((2, 16), (4, 64)):
        jb, tb = _bev_config(jconfig, rows), _bev_config(tconfig, rows)
        batch = jmake_batch(jb, batch_size=2, seed=7)
        bev[S] = dict(jcfg=_space(jb, S, shard_cameras=False),
                      cfg=_space(tb, S, shard_cameras=False),
                      batch=batch, variables=_variables(jb, batch))
    torch.save(dict(
        ocrf_eval=dict(cfg=cfg2, variables=v, batch=eval_batch),
        bev={k: bev[2][k] for k in ("cfg", "variables", "batch")},
        step=dict(cfg=cfg2, variables=v, batch=step_batch)),
        out / "two_in.pt")
    # the 4-rank inputs: the 64-row model at space 4; the trainer of the
    # tiny config (stereo on, ASPP dropout on) on a 2 x 2 grid
    tcfg = tconfig.tiny_config()
    tcfg = dataclasses.replace(tcfg, vt=dataclasses.replace(
        tcfg.vt, depthnet=dataclasses.replace(tcfg.vt.depthnet,
                                              aspp_dropout=0.1)))
    pkl = build_fake_nuscenes(str(out / "data"), tcfg, n_samples=4)
    torch.save(dict(bev={k: bev[4][k] for k in ("cfg", "variables",
                                                 "batch")},
                    cfg=_space(tcfg, 2, shard_cameras=True), cfg1=tcfg,
                    pkl=pkl), out / "four_in.pt")

    # the ranks and JAX's compiles (one thread each: XLA compiles with
    # the GIL released) side by side, the port's single rank meanwhile
    two, four = _launch("two", 2, out), _launch("four", 4, out)
    with ThreadPoolExecutor(4) as pool:
        j_eval = pool.submit(_jax_forwards, jcfg2, v, eval_batch, 2,
                             train=False)
        j_bev = {S: pool.submit(_jax_forwards, b["jcfg"], b["variables"],
                                b["batch"], S, train=True)
                 for S, b in bev.items()}
        j_step = pool.submit(_jax_step, jcfg2, v, step_batch, 2)
        one_eval = _single_forwards(cfg, v, eval_batch, train=False)
        one_bev = {S: _single_forwards(b["cfg"], b["variables"], b["batch"],
                                       train=True) for S, b in bev.items()}
        one_grads, one_losses, one_stats = _single_grads(cfg, v,
                                                         step_batch)
        _wait(two, out, "two", 2)
        _wait(four, out, "four", 4)
        one = _launch("one", 1, out)
        _wait(one, out, "one", 1)
        j_eval, j_bev = j_eval.result(), {S: f.result()
                                          for S, f in j_bev.items()}
        jstate, jmetrics = j_step.result()
    torch.set_num_threads(threads)

    scopes = conv_transpose_scopes(OcRFDet(cfg, render_heads=True))

    def sd(params, stats=None):
        tree = {"params": _np(params)}
        if stats is not None:
            tree["batch_stats"] = _np(stats)
        return flax_to_state_dict(tree, scopes)
    two_out = torch.load(out / "two.pt", weights_only=False)
    return dict(
        out=out, cfg=cfg2, variables=v, scopes=scopes, two=two_out,
        four=torch.load(out / "four.pt", weights_only=False),
        four_metrics=torch.load(out / "four_metrics.pt", weights_only=False),
        one=torch.load(out / "one.pt", weights_only=False),
        j_eval=j_eval, j_bev=j_bev, one_eval=one_eval, one_bev=one_bev,
        one_grads=one_grads, one_losses=one_losses, one_stats=one_stats,
        jgrads=sd(jstate.opt_state[0]), step=two_out["step"],
        jmetrics=_np(jmetrics),
        jraw=sd(jstate.params, jstate.batch_stats),
        jema=sd(jstate.ema_params, jstate.ema_batch_stats),
        jmu=sd(_moments(jstate.opt_state[1], "mu")),
        jnu=sd(_moments(jstate.opt_state[1], "nu")), jstep=int(jstate.step))


@pytest.mark.parametrize("S", [2, 3, 4])
def test_halo_primitives_match_the_full_grid(S, tmp_path):
    """halo_exchange_rows (up/down 1/1, 1/0, 2/2, 0/1), all_gather_cat,
    psum and slice_rows exactly, and their backwards as the forwards'
    transposes; ConvBN at stride 1 and 2 with the grid's BatchNorm
    statistics, a 3x3 conv and the blocked upsampling within fp32
    rounding, with their gradients (checked in the worker)."""
    torch_threads = torch.get_num_threads()
    _wait(_launch("halo", S, tmp_path), tmp_path, "halo", S)
    torch.set_num_threads(torch_threads)
    for r in range(S):
        rep = torch.load(tmp_path / f"halo_{S}_{r}.pt")
        assert rep == {"halo11": True, "halo10": True, "halo22": True,
                       "halo01": True, "gather_psum": True,
                       "blocked_ops": True}


def _close_to_scale(got, want, rel, name):
    err = float(np.max(np.abs(np.asarray(got, np.float64)
                              - np.asarray(want, np.float64))))
    scale = float(np.max(np.abs(np.asarray(want, np.float64))))
    assert err <= rel * max(scale, 1e-6), (name, err, scale)


def test_space_eval_matches_jax_and_one_rank(run):
    """The tiny OcRF eval forward at space 2 with every phase on (camera
    blocks through the view transformer, BEV row blocks; the render
    bands are a training path) against JAX's 1 x 2 mesh and the port's
    single rank."""
    got = run["two"]["ocrf_eval"]
    jpreds, jaux = run["j_eval"]
    for g, j, o in zip(got["preds"], _preds(jpreds), run["one_eval"]["eval"]):
        for k in j:
            np.testing.assert_allclose(g[k].numpy(), j[k], rtol=2e-3,
                                       atol=2e-4, err_msg=k)
            _close_to_scale(g[k], o[k], 1e-5, k)
    for k in ("depth", "semantic", "bev_mask_logit", "opacity_bev_logit"):
        assert got["aux"][k].shape == run["one_eval"]["aux"][k].shape
        np.testing.assert_allclose(got["aux"][k].numpy(), np.asarray(jaux[k]),
                                   rtol=2e-3, atol=2e-4, err_msg=k)
        _close_to_scale(got["aux"][k], run["one_eval"]["aux"][k], 1e-5, k)
    assert got["aux"]["fpn_key"].shape == run["one_eval"]["aux"]["fpn_key"] \
        .shape


def _assert_close(got, want, rtol, atol, name):
    """allclose with atol a multiple of max(1, the output's scale): the
    random weights give outputs up to ~10."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol,
        atol=atol * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_bev_row_blocks_match_jax_and_one_rank(run, S, mode):
    """The LSS model's BEV stack on S row blocks (no camera sharding):
    the 16-row grid at S = 2, the 64-row grid at S = 4 (the stride-2
    stages need blocks of 8 rows); to the port's single rank at JAX's
    bounds, to JAX's sharded forward at the packages' bounds."""
    got = run["two"]["bev"] if S == 2 else run["four"]
    one = run["one_bev"][S]
    j_eval, j_train, j_stats = run["j_bev"][S]
    jpreds = j_eval[0] if mode == "eval" else j_train
    one_tol = (1e-4, 1e-5) if mode == "eval" else (1e-3, 5e-4)
    jax_tol = (1e-4, 1e-4) if mode == "eval" else (1e-3, 1e-3)
    for g, j, o in zip(got[mode], _preds(jpreds), one[mode]):
        for k in j:
            _assert_close(g[k], o[k], *one_tol, f"{mode} {k} vs one rank")
            _assert_close(g[k], j[k], *jax_tol, f"{mode} {k} vs JAX")
    if mode == "train":
        want = flax_to_state_dict({"batch_stats": _np(j_stats)})
        for k, t in got["stats"].items():
            np.testing.assert_allclose(t.numpy(), one["stats"][k].numpy(),
                                       rtol=1e-3, atol=1e-4, err_msg=k)
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-3,
                                       atol=1e-4, err_msg=k)


def _pooled(a_tree, b_tree):
    """JAX's metric per top-level module (the render heads apart): the
    least-squares scale of b on a and their cosine."""
    groups = {}
    for n, a in a_tree.items():
        top = n.split(".")[0]
        if optim.is_render_param(n):
            top += " (render heads)"
        a = a.double().ravel()
        b = b_tree[n].double().ravel()
        ab, aa, bb = groups.setdefault(top, [0.0, 0.0, 0.0])
        groups[top] = [ab + float(a @ b), aa + float(a @ a),
                       bb + float(b @ b)]
    return {top: (ab / aa, ab / np.sqrt(aa * bb))
            for top, (ab, aa, bb) in groups.items() if aa > 1e-10}


def _assert_pooled(want, got, name, lo=0.9, hi=1.1, cos=0.95):
    pooled = _pooled(want, got)
    assert len(pooled) >= 8, (name, sorted(pooled))
    for top, (scale, c) in pooled.items():
        assert lo < scale < hi, (name, top, scale, c)
        assert c > cos, (name, top, scale, c)


def test_space_raw_gradients_are_the_unsharded_ones(run):
    """The raw averaged gradients of the 2 space ranks (each rank's
    gradient of the replicated loss, then the grid's mean) against the
    port's single rank and JAX's raw space-mesh gradients: scale 1 per
    module, not 2 (a gradient counted once per rank) and not 1/2; the
    losses to the port's single rank at rtol 1e-3 and to JAX's at rtol
    1e-2 (JAX's own space mesh moves task0.loss_whl by 5e-3 from its
    single device on this batch)."""
    got = run["step"]["grads"]
    _assert_pooled(run["one_grads"], got, "one rank")
    _assert_pooled(run["jgrads"], got, "JAX")
    losses = run["step"]["losses"]
    assert set(losses) == set(run["one_losses"])
    for k, want in run["one_losses"].items():
        np.testing.assert_allclose(losses[k], want, rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    for k, want in run["jmetrics"].items():
        if k != "skipped_nonfinite":
            np.testing.assert_allclose(losses[k], float(want), rtol=1e-2,
                                       atol=1e-6, err_msg=k)


def test_space_step_matches_jax_step(run):
    """Parameters, BatchNorm statistics and both EMA trees after one step
    on the 1 x 2 grid, gathered from the ranks, against JAX's
    `build_train_step` on its 1 x 2 mesh (the BatchNorm statistics at
    atol 2e-4: on this batch the packages' unsharded models differ by up
    to 1.3e-4 in them, measured), and the statistics against the port's
    single rank at rtol 1e-3 / atol 1e-5; the step count."""
    check_step_matches_jax(run, run["step"], 1, bn_atol=2e-4)
    model = run["step"]["state"]["model"]
    for k, want in run["one_stats"].items():
        np.testing.assert_allclose(model[k].numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["m", "v"])
def test_space_gathered_moments_match_jax(run, kind):
    """AdamW's moments, ZeRO slices of the 2 ranks gathered, against
    JAX's, as the gradients are held (by module) and within a relative
    L2 error of 0.05 over all tensors: the first moment (0.1 times the
    clipped gradient) and the second's square root (sqrt(0.001) times
    the clipped gradient's magnitude)."""
    state = run["step"]["state"]["optimizer"]
    got = {k[2:]: t for k, t in state.items() if k.startswith(kind + ".")}
    want = run["jmu"] if kind == "m" else run["jnu"]
    assert set(got) == set(want)
    if kind == "v":
        got = {k: t.sqrt() for k, t in got.items()}
        want = {k: t.sqrt() for k, t in want.items()}
    _assert_pooled(want, got, "JAX")
    g = torch.cat([got[n].ravel() for n in sorted(want)]).double()
    w = torch.cat([want[n].ravel() for n in sorted(want)]).double()
    assert float((g - w).norm()) <= 0.05 * float(w.norm())
    # the step's collectives: the camera and row sums, the gathers, the
    # halos and the grid's means all ran
    counts = run["step"]["collectives"]
    assert counts["all_reduce"][0] > 0 and counts["all_gather"][0] > 0


def test_grid_checkpoint_resumes_on_one_rank_bitwise(run):
    """The 2 x 2 grid's trainer (rows by data index, cameras by space
    index) writes the whole state; a 1-rank data-parallel trainer
    resumes it bit for bit, and its next step gives the bits of a
    single-device trainer resumed from the same file."""
    one = run["one"]
    ckpt = torch.load(run["out"] / "train" / "ckpt_epoch_1.pt",
                      weights_only=False)
    assert len(ckpt["generators"]) == 4
    assert run["four_metrics"][0]["skipped_nonfinite"] == 0.0
    assert np.isfinite(run["four_metrics"][0]["loss_total"])
    dp, single = one["dp"], one["single"]
    assert dp["start"] == single["start"] == 2
    res = dp["resumed"]
    assert res["step"] == ckpt["step"] == 1
    for part in ("model", "optimizer", "ema_params", "ema_stats"):
        assert set(res[part]) == set(ckpt[part])
        for k, t in ckpt[part].items():
            assert torch.equal(res[part][k], t), (part, k)
    assert torch.equal(res["generator"], ckpt["generators"][0])
    assert dp["metrics"] == single["metrics"]
    for part in ("model", "optimizer", "ema_params", "ema_stats"):
        for k, t in single["state"][part].items():
            assert torch.equal(dp["state"][part][k], t), (part, k)


def test_space_refuses_what_jax_cannot_run():
    """Camera sharding needs the cameras to split over the space ranks;
    a space axis of another size than the config's is refused."""
    from ocrfdet_tpu_torch.parallel.collectives import Axis
    cfg = tconfig.tiny_config()
    with pytest.raises(ValueError, match="cameras"):
        OcRFDet(_space(cfg, 3, shard_cameras=True))
    OcRFDet(_space(cfg, 3, shard_cameras=False))
    model = OcRFDet(_space(cfg, 2, shard_cameras=True))
    with pytest.raises(ValueError, match="space axis of 4"):
        model.set_space(Axis(None, 4, 0))
