"""The port's training step against the JAX package's on the CPU, at the
tiny OcRF config in fp32 with the depth net's stereo branch off (see
below), from the same weights (JAX's init for training, with random
BatchNorm scales and biases; the weight bridge loads them strictly,
render heads included) and the same training batch (seed 0, batch 2).
JAX runs its own train step (`parallel/step.py::build_train_step`) on a
1 x 1 mesh; its tiled renderer composites with the XLA scan, the port
with K5's plain version.

Why the stereo branch is off: JAX's CPU cost volume interpolates the
previous frame's features in bf16 (ops/cost_volume.py::cost_volume_scan),
which alone moves this step's losses by up to 40% between the packages,
and with use_stereo=False the zero cost volume feeds two BatchNorms a
constant input, whose batch-statistics output is rounding noise times
1/sqrt(eps). test_torch_train_stereo.py holds the stereo step against
JAX, with JAX's cost volumes replayed in both packages.

Tolerances, with what they rest on:
* the loss dict: rtol 1e-3 (measured max 5e-4). Train-mode BatchNorm
  normalises with batch statistics, which flax computes as
  E[x^2] - E[x]^2 and torch in two passes;
* the gradients: relative L2 error over all parameters <= 0.05
  (measured 0.02) and per tensor <= 0.25 (measured 0.12, in a weight of
  the max-pooled height attention) of the tensor's L2 norm, floored at
  1e-3 of the mean tensor norm (the biases of convs that feed a
  train-mode BatchNorm have a gradient of exactly 0 in exact arithmetic,
  so theirs is rounding noise). The gradient of this config is chaotic
  in fp32: a 1e-6 relative perturbation of the weights alone moves it by
  18% overall and by up to 36% in one tensor (ties in the max-based
  attention gates flip; several BatchNorms see 4 samples), so the port
  agrees with JAX several times better than that;
* after one step, taken at the full learning rate (warmup_ratio 1, so
  that the update, 2e-4 and 4e-4 for the render group, stands far above
  the parameters' fp32 spacing and the EMA's move, 0.6% of it, can be
  read): on the entries whose gradient the two packages agree on (the
  clipped JAX gradient above 1e-5, 1000 times Adam's eps, and the
  port's within half of it, where Adam's first update is the learning
  rate times the gradient's sign to 0.2%), the parameters' change to 1% of the learning rate
  and the EMA's change to 1% of its own size, each plus two fp32
  spacings of the value; every parameter to 2.5 times the learning
  rate; the BatchNorm running statistics and their EMA to rtol 1e-3 /
  atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.data.synthetic import make_batch as jmake_batch
from ocrfdet_tpu.models.detector import OcRFDet as JaxOcRFDet
from ocrfdet_tpu.parallel.mesh import make_mesh
from ocrfdet_tpu.parallel.step import build_train_step
from ocrfdet_tpu.train.optim import create_train_state, make_optimizer
from ocrfdet_tpu.train.trainstep import compute_losses as jcompute_losses
from ocrfdet_tpu.train.trainstep import total_loss as jtotal_loss
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.train import optim
from ocrfdet_tpu_torch.train.step import TrainState, train_step
from ocrfdet_tpu_torch.train.trainstep import compute_losses, total_loss
from ocrfdet_tpu_torch.utils.weights import (conv_transpose_scopes,
                                             flax_to_state_dict,
                                             load_flax_variables)

STEPS_PER_EPOCH = 100


def _config(mod):
    c = mod.tiny_config(use_stereo=False)
    return dataclasses.replace(
        c, vt=dataclasses.replace(c.vt, depthnet=dataclasses.replace(
            c.vt.depthnet, stereo=False)),
        optim=dataclasses.replace(c.optim, warmup_ratio=1.0))


def random_variables(shapes, seed=0):
    """numpy variables for the shapes of a flax init: flax's default
    kernel init (truncated normal of variance 1 / fan_in), the raw
    parameters' own inits, random BatchNorm scales and random biases
    (JAX's init is not compiled: its shapes come from eval_shape)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name, shape = path[-1].key, x.shape
        if name == "kernel":
            std = np.sqrt(1.0 / np.prod(shape[:-1])) / 0.87962566103423978
            v = np.clip(rng.standard_normal(shape), -2, 2) * std
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "bias":
            v = rng.normal(0.0, 0.2, shape)
        elif name in ("mean", "height_b"):
            v = np.zeros(shape)
        elif name == "var":
            v = np.ones(shape)
        elif name == "height_w":
            v = rng.standard_normal(shape)
        elif name in ("row_embed", "col_embed"):
            v = rng.uniform(0.0, 1.0, shape)
        elif name == "w":
            v = np.full(shape, 0.5)
        else:
            raise KeyError(name)
        return v.astype(np.float32)
    return {k: jax.tree_util.tree_map_with_path(leaf, dict(v))
            for k, v in shapes.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def run():
    jcfg, cfg = _config(jconfig), _config(tconfig)
    jm = JaxOcRFDet(jcfg)
    jb = jax.tree.map(jnp.asarray, jmake_batch(jcfg, batch_size=2, seed=0))
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb,
                                       train=True))
    v = random_variables({"params": v["params"],
                          "batch_stats": v["batch_stats"]})

    def loss_fn(params, b):
        (preds, aux), mut = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, b,
            train=True, mutable=["batch_stats"])
        losses = jcompute_losses(jcfg, preds, aux, b)
        return jtotal_loss(losses), losses
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], jb)

    tx = make_optimizer(jcfg.optim, v["params"], STEPS_PER_EPOCH)
    mesh = make_mesh(data=1, space=1, devices=jax.devices()[:1])
    jstate, jmetrics = build_train_step(jcfg, jm, tx, mesh)(
        create_train_state(jax.tree.map(jnp.asarray, v), tx), jb)

    # the port: one forward/backward, then one step on a fresh state
    tb = entry.make_batch(cfg, seed=0, batch_size=2, device="cpu",
                          with_targets=True)
    model = load_flax_variables(OcRFDet(cfg, render_heads=True), v).train()
    preds, aux = model(tb)
    losses = compute_losses(cfg, preds, aux, tb)
    total_loss(losses).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    state = TrainState(cfg, load_flax_variables(
        OcRFDet(cfg, render_heads=True), v), STEPS_PER_EPOCH)
    metrics = train_step(state, tb)
    scopes = conv_transpose_scopes(model)
    return dict(
        cfg=cfg, batch=tb, variables=v, losses=losses, jlosses=_np(jlosses),
        grads=grads, jgrads=flax_to_state_dict(
            {"params": _np(jgrads)}, scopes), state=state, metrics=metrics,
        jmetrics=_np(jmetrics), scopes=scopes,
        jstate={k: flax_to_state_dict({"params": _np(getattr(jstate, p)),
                                       "batch_stats": _np(getattr(jstate, s))},
                                      scopes)
                for k, p, s in (("raw", "params", "batch_stats"),
                                ("ema", "ema_params", "ema_batch_stats"))},
        jstep=int(jstate.step))


def test_weight_bridge_loads_the_render_heads(run):
    """The JAX variables of a model initialised for training carry the
    render-only heads; the bridge maps every one of them."""
    sd = flax_to_state_dict(run["variables"], run["scopes"])
    heads = {k.split(".")[1] for k in sd
             if k.startswith("img_view_transformer.")}
    assert {"S_MLP", "R_MLP", "C_MLP", "C_MLP_nerf", "D_MLP_nerf",
            "img_feat_resize1", "img_feat_resize2", "blend_img",
            "blend_depth"} <= heads
    assert set(sd) == set(run["state"].model.state_dict())


def test_train_loss_dict_matches_jax(run):
    got, want = run["losses"], run["jlosses"]
    assert set(got) == set(want)
    assert {"loss_gs_color", "loss_gs_ssim", "loss_render_depth",
            "mask_ce_opacity_loss", "task5.loss_vel"} <= set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3,
                                   atol=1e-6, err_msg=k)


def test_train_grads_match_jax(run):
    got, want = run["grads"], run["jgrads"]
    assert set(got) == set(want)
    names = sorted(want)
    g = torch.cat([got[n].ravel() for n in names]).numpy()
    w = np.concatenate([want[n].numpy().ravel() for n in names])
    assert np.linalg.norm(g - w) <= 0.05 * np.linalg.norm(w)
    floor = 1e-3 * np.mean([np.linalg.norm(want[n].numpy()) for n in names])
    for n in names:
        err = np.linalg.norm(got[n].numpy() - want[n].numpy())
        scale = max(np.linalg.norm(want[n].numpy()), floor)
        assert err <= 0.25 * scale, (n, err, scale)


def test_train_step_matches_jax_step(run):
    """Parameters, BatchNorm statistics and both EMA trees after one
    step; the step count and the reported losses."""
    state, jstate = run["state"], run["jstate"]
    cfg = run["cfg"].optim
    assert state.step == run["jstep"] == 1
    assert run["metrics"]["skipped_nonfinite"] == 0.0
    assert float(run["jmetrics"]["skipped_nonfinite"]) == 0.0
    np.testing.assert_allclose(run["metrics"]["loss_total"],
                               float(run["jmetrics"]["loss_total"]),
                               rtol=1e-3)
    lr = optim.lr_at(cfg, 0)
    assert lr == float(np.float32(cfg.lr))
    decay = optim.ema_decay(cfg, 0)
    init = flax_to_state_dict(run["variables"], run["scopes"])
    sd = state.model.state_dict()
    ema = {**state.ema_params.as_dict(), **state.ema_stats.as_dict()}
    render = set(state.optimizer.names["render"])
    n_checked = {"render": 0, "other": 0}
    # the clip's scale of JAX's gradient: Adam's first update is the
    # learning rate times g / (|g| + 1e-8) of the clipped gradient g
    jnorm = np.sqrt(sum(float((g.numpy().astype(np.float64) ** 2).sum())
                        for g in run["jgrads"].values()))
    clip = min(1.0, cfg.grad_clip_norm / jnorm)
    for k, want in jstate["raw"].items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(ema[k].numpy(),
                                       jstate["ema"][k].numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)
            continue
        k_lr = lr * cfg.lr_mult_render if k in render else lr
        p0 = init[k].numpy()
        np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=0,
                                   atol=2.5 * k_lr, err_msg=k)
        jg, tg = run["jgrads"][k].numpy(), run["grads"][k].numpy()
        agree = ((np.abs(jg) * clip > 1e-5)
                 & (np.abs(tg - jg) < 0.5 * np.abs(jg)))
        spacing = 2 * np.spacing(np.abs(p0) + 2.5 * k_lr)
        for got, wnt, size in ((sd[k], want, k_lr),
                               (ema[k], jstate["ema"][k],
                                (1 - decay) * k_lr)):
            d_got = (got.numpy() - p0)[agree]
            d_want = (wnt.numpy() - p0)[agree]
            np.testing.assert_array_less(np.abs(d_got - d_want),
                                         0.01 * size + spacing[agree],
                                         err_msg=k)
        n_checked["render" if k in render else "other"] += int(agree.sum())
    total = sum(v.numel() for k, v in sd.items()
                if k in run["grads"])
    assert min(n_checked.values()) > 100     # render: 191 entries
    assert sum(n_checked.values()) > 0.5 * total


def test_guard_skips_a_nonfinite_step(run):
    """A NaN planted in the batch: the step reports skipped_nonfinite 1
    and leaves every tensor of the state as it was."""
    state = TrainState(run["cfg"], load_flax_variables(
        OcRFDet(run["cfg"], render_heads=True), run["variables"]))
    tensors = (list(state.model.state_dict().values())
               + state.optimizer.state_tensors()
               + state.ema_params.ema + state.ema_stats.ema)
    before = [t.clone() for t in tensors]
    batch = dict(run["batch"])
    batch["imgs"] = batch["imgs"].clone()
    batch["imgs"][0, 0, 0, 0, 0, 0] = float("nan")
    metrics = train_step(state, batch)
    assert metrics["skipped_nonfinite"] == 1.0
    assert not np.isfinite(metrics["loss_total"])
    assert state.step == 0
    for a, b in zip(tensors, before):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
