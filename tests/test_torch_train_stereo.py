"""The port's training forward and backward against the JAX package's on
the CPU with the depth net's stereo branch on: the tiny OcRF config as
configured (stereo, fp32), the weights and batch of
test_torch_train_step.py (JAX's init for training with random BatchNorm
scales and biases; seed 0, batch 2).

JAX's CPU cost volume (ops/cost_volume.py::cost_volume_scan) weights and
sums the interpolated taps of the previous frame in bf16, the port in
fp32 (both round the previous frame's features to bf16). This step is
far more sensitive to its cost volume than to anything else: with each
package's own cost volume the losses differ by up to 40% and the
gradient by 103% (relative L2). So the step is compared twice:
* with each package's own cost volume, the loss dict only: rtol 1.0
  (measured 0.40), which still fails on a loss that is missing, doubled
  or of the wrong sign;
* with JAX's two cost volumes of this step (recorded from its jitted
  forward) replayed as constants in both packages, which holds
  everything after the cost volume (the depth net's stereo convolutions
  and train-mode BatchNorms, and the rest of the step) against JAX: the
  loss dict to rtol 1e-2 (measured max 2.0e-3), the gradient to a
  relative L2 error over all parameters of 0.15 (measured 0.053) and
  per tensor of 0.6 (measured 0.31, in the channel attention of the
  BEV mask head) of the tensor's L2 norm, floored at 1e-3 of the mean
  tensor norm, as in test_torch_train_step.py (stereo off: 5e-4 and
  0.02).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import random_variables

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.data.synthetic import make_batch as jmake_batch
from ocrfdet_tpu.models import detector as jdetector
from ocrfdet_tpu.models.depthnet import \
    stereo_cost_volume as jstereo_cost_volume
from ocrfdet_tpu.models.detector import OcRFDet as JaxOcRFDet
from ocrfdet_tpu.train.trainstep import compute_losses as jcompute_losses
from ocrfdet_tpu.train.trainstep import total_loss as jtotal_loss
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.models import detector as tdetector
from ocrfdet_tpu_torch.train.trainstep import compute_losses, total_loss
from ocrfdet_tpu_torch.utils.weights import (conv_transpose_scopes,
                                             flax_to_state_dict,
                                             load_flax_variables)


def _run():
    jcfg, cfg = jconfig.tiny_config(), tconfig.tiny_config()
    assert cfg.use_stereo and cfg.vt.depthnet.stereo
    jm = JaxOcRFDet(jcfg)
    jb = jax.tree.map(jnp.asarray, jmake_batch(jcfg, batch_size=2, seed=0))
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb,
                                       train=True))
    v = random_variables({"params": v["params"],
                          "batch_stats": v["batch_stats"]})

    def apply(params, b):
        (preds, aux), _ = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, b,
            train=True, mutable=["batch_stats"])
        losses = jcompute_losses(jcfg, preds, aux, b)
        return jtotal_loss(losses), losses

    def grads(params, b):
        return jax.jit(jax.value_and_grad(apply, has_aux=True))(params, b)
    (_, jlosses), jgrads = grads(v["params"], jb)

    # JAX's cost volumes of this forward, then the same step with them
    # replayed as constants in both packages
    recorded = []

    def record(*args, **kw):
        out = jstereo_cost_volume(*args, **kw)
        recorded.append(out)
        return out

    def cost_volumes(params, b):
        recorded.clear()
        apply(params, b)
        return list(recorded)
    with mock.patch.object(jdetector, "stereo_cost_volume", record):
        cvs = [np.asarray(c) for c in jax.jit(cost_volumes)(v["params"], jb)]
    with mock.patch.object(jdetector, "stereo_cost_volume",
                           _replay([jnp.asarray(c) for c in cvs])):
        (_, rjlosses), rjgrads = grads(v["params"], jb)

    tb = entry.make_batch(cfg, seed=0, batch_size=2, device="cpu",
                          with_targets=True)

    def port():
        model = load_flax_variables(OcRFDet(cfg, render_heads=True),
                                    v).train()
        preds, aux = model(tb)
        losses = compute_losses(cfg, preds, aux, tb)
        total_loss(losses).backward()
        return ({k: float(t.detach()) for k, t in losses.items()},
                {n: p.grad.numpy() for n, p in model.named_parameters()},
                conv_transpose_scopes(model))
    losses, tgrads, scopes = port()
    replay = _replay([torch.tensor(c) for c in cvs])
    with mock.patch.object(tdetector, "stereo_cost_volume", replay):
        rlosses, rgrads, _ = port()
    assert replay.calls == len(cvs) == 2

    def np_grads(g):
        return {k: t.numpy() for k, t in flax_to_state_dict(
            {"params": jax.tree.map(np.asarray, g)}, scopes).items()}
    return dict(
        losses=losses, grads=tgrads, rlosses=rlosses, rgrads=rgrads,
        jlosses={k: float(t) for k, t in jlosses.items()},
        rjlosses={k: float(t) for k, t in rjlosses.items()},
        jgrads=np_grads(jgrads), rjgrads=np_grads(rjgrads))


def _replay(volumes):
    """A stand-in for stereo_cost_volume that returns `volumes` in call
    order, whatever its inputs."""
    def f(*args, **kw):
        f.calls += 1
        return volumes[(f.calls - 1) % len(volumes)]
    f.calls = 0
    return f


@pytest.fixture(scope="module")
def run():
    return _run()


def test_train_stereo_loss_dict_matches_jax(run):
    got, want = run["losses"], run["jlosses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1.0, atol=1e-6,
                                   err_msg=k)


def test_train_stereo_with_jax_cost_volume_matches_jax(run):
    got, want = run["rlosses"], run["rjlosses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, atol=1e-6,
                                   err_msg=k)
    got, want = run["rgrads"], run["rjgrads"]
    assert set(got) == set(want)
    names = sorted(want)
    g = np.concatenate([got[n].ravel() for n in names])
    w = np.concatenate([want[n].ravel() for n in names])
    assert np.linalg.norm(g - w) <= 0.15 * np.linalg.norm(w)
    floor = 1e-3 * np.mean([np.linalg.norm(want[n]) for n in names])
    for n in names:
        err = np.linalg.norm(got[n] - want[n])
        assert err <= 0.6 * max(np.linalg.norm(want[n]), floor), n
