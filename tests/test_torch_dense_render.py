"""`vt.renderer="dense"` in the port against the JAX package on the CPU:
the tiny OcRF config in fp32 (stereo branch off, as
tests/test_torch_train_step.py and for its reasons), train mode, the
same weights and training batch (seed 0, batch 2). Both packages render
each sample's camera with the exact dense compositor (no per-tile cap;
the port's `ops/splat/render_dense.py`, held to JAX's dense renderer by
tests/test_torch_train_ops.py), and the port must not reach the tiled
renderer or kernel K5.

Tolerances: the Gaussian render (image and median depth) rtol 1e-4, atol
1e-4 of its scale (the renderer tests' tolerance); the blended renders
and the loss dict rtol 1e-3 (the training-step test's: train-mode
BatchNorm normalises with batch statistics, which flax computes as
E[x^2] - E[x]^2 and torch in two passes).
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
from ocrfdet_tpu.train.trainstep import compute_losses as jcompute_losses
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.models.ocrf import view_transformer_ocrf as tvt
from ocrfdet_tpu_torch.ops.splat import composite
from ocrfdet_tpu_torch.train.trainstep import compute_losses
from ocrfdet_tpu_torch.utils.weights import load_flax_variables
from test_torch_train_step import _config, random_variables

RENDERS = ("render_img_g", "render_depth_g", "render_img", "render_depth")


def _dense(mod):
    c = _config(mod)
    return dataclasses.replace(c, vt=dataclasses.replace(c.vt,
                                                         renderer="dense"))


@pytest.fixture(scope="module")
def run(monkeypatch_module):
    jcfg, cfg = _dense(jconfig), _dense(tconfig)
    jm = JaxOcRFDet(jcfg)
    jb = jax.tree.map(jnp.asarray, jmake_batch(jcfg, batch_size=2, seed=0))
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb,
                                       train=True))
    v = random_variables({"params": v["params"],
                          "batch_stats": v["batch_stats"]})

    def forward(variables, b):
        (preds, aux), _ = jm.apply(variables, b, train=True,
                                   mutable=["batch_stats"])
        return aux, jcompute_losses(jcfg, preds, aux, b)
    jaux, jlosses = jax.jit(forward)(jax.tree.map(jnp.asarray, v), jb)

    def refuse(*args, **kwargs):
        raise AssertionError("the tiled renderer ran with renderer='dense'")
    monkeypatch_module.setattr(tvt, "render_gaussians_tiled", refuse)
    monkeypatch_module.setattr(composite, "composite_tiles", refuse)
    tb = entry.make_batch(cfg, seed=0, batch_size=2, device="cpu",
                          with_targets=True)
    model = load_flax_variables(OcRFDet(cfg, render_heads=True), v).train()
    with torch.no_grad():
        preds, aux = model(tb)
        losses = compute_losses(cfg, preds, aux, tb)
    return dict(aux=aux, losses=losses,
                jaux={k: np.asarray(jaux[k]) for k in RENDERS},
                jlosses={k: float(x) for k, x in jlosses.items()})


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("key", RENDERS)
def test_dense_render_matches_jax(run, key):
    got, want = run["aux"][key].numpy(), run["jaux"][key]
    assert got.shape == want.shape
    rtol = 1e-4 if key.endswith("_g") else 1e-3
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()))


def test_dense_render_losses_match_jax(run):
    got, want = run["losses"], run["jlosses"]
    assert set(got) == set(want)
    assert {"loss_gs_color", "loss_gs_ssim", "loss_render_depth"} <= set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-3,
                                   atol=1e-6, err_msg=k)
