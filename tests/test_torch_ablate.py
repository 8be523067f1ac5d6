"""The `vt.ablate` profiling seams of the OcRF view transformer
(ocrfdet_tpu_torch/models/ocrf/view_transformer_ocrf.py) against the JAX
package's (ocrfdet_tpu/models/ocrf/view_transformer_ocrf.py: "nerf",
"render", "sample", "hoa", "splat", "nerfcomp"), on the CPU at the tiny
config in fp32.

* Parameter sets. flax creates a module's parameters when it is called,
  so a seam can drop submodules from JAX's init. For each seam, in eval
  and in train mode, the port's model (`render_heads` in train mode, as
  the trainer builds it) must load JAX's init tree through the weight
  bridge with `strict=True`: every key on each side, every shape. JAX's
  tree comes from `jax.eval_shape` of its init (nothing compiles).
* Training. Three combined ablations cover the six seams:
  ("nerf", "hoa", "splat"), ("sample", "nerfcomp") and ("render",). For
  each, JAX's value_and_grad of the tiny training step and the port's
  forward and backward, from the same weights and batch (those of
  tests/test_torch_train_step.py: stereo off, seed 0, batch 2), give the
  same loss dict (rtol 1e-3 as there) and the same set of parameters
  with a non-zero gradient (the port's None counts as zero). A seam
  leaves the heads whose outputs it replaces by zeros with a gradient of
  exactly 0 in both packages; the gradients that are 0 only in exact
  arithmetic (the biases of convs that feed a train-mode BatchNorm)
  come out as rounding noise, 1e-9 to 3e-6 of the mean tensor norm, in
  both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import random_variables

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.data.synthetic import make_batch as jmake_batch
from ocrfdet_tpu.models.detector import OcRFDet as JaxOcRFDet
from ocrfdet_tpu.train.trainstep import compute_losses as jcompute_losses
from ocrfdet_tpu.train.trainstep import total_loss as jtotal_loss
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.models.ocrf.view_transformer_ocrf import SEAMS
from ocrfdet_tpu_torch.train.trainstep import compute_losses, total_loss
from ocrfdet_tpu_torch.utils.weights import (conv_transpose_scopes,
                                             flax_to_state_dict,
                                             load_flax_variables)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(mod, ablate):
    c = mod.tiny_config(use_stereo=False)
    return dataclasses.replace(c, vt=dataclasses.replace(
        c.vt, ablate=tuple(ablate), depthnet=dataclasses.replace(
            c.vt.depthnet, stereo=False)))


def _jax_variables(jcfg, train):
    jm = JaxOcRFDet(jcfg)
    jb = jax.tree.map(jnp.asarray, jmake_batch(jcfg, batch_size=2, seed=0))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb,
                                            train=train))
    return jm, jb, random_variables({"params": shapes["params"],
                                     "batch_stats": shapes["batch_stats"]})


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("seam", SEAMS)
def test_seam_parameters_map_onto_jax_init(seam, train):
    jcfg, cfg = _config(jconfig, (seam,)), _config(tconfig, (seam,))
    _, _, v = _jax_variables(jcfg, train)
    model = OcRFDet(cfg, render_heads=train)
    load_flax_variables(model, v)            # strict: raises on a mismatch
    full = OcRFDet(_config(tconfig, ()), render_heads=train)
    dropped = set(full.state_dict()) - set(model.state_dict())
    # each seam drops something from the model it ablates, except
    # "sample" and "splat", which keep every head, and "render" and
    # "nerfcomp" in eval, where no render head exists
    kept = seam in ("sample", "splat") or (
        seam in ("render", "nerfcomp") and not train)
    assert bool(dropped) != kept, sorted(dropped)[:5]


def _train_step_both(ablate):
    jcfg, cfg = _config(jconfig, ablate), _config(tconfig, ablate)
    jm, jb, v = _jax_variables(jcfg, True)

    def loss_fn(params, b):
        (preds, aux), _ = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, b,
            train=True, mutable=["batch_stats"])
        losses = jcompute_losses(jcfg, preds, aux, b)
        return jtotal_loss(losses), losses
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], jb)

    model = load_flax_variables(OcRFDet(cfg, render_heads=True), v).train()
    batch = entry.make_batch(cfg, seed=0, batch_size=2, device="cpu",
                             with_targets=True)
    preds, aux = model(batch)
    losses = compute_losses(cfg, preds, aux, batch)
    total_loss(losses).backward()
    grads = {n: (p.grad.numpy() if p.grad is not None
                 else np.zeros(tuple(p.shape), np.float32))
             for n, p in model.named_parameters()}
    jgrads = {k: t.numpy() for k, t in flax_to_state_dict(
        {"params": jax.tree.map(np.asarray, jgrads)},
        conv_transpose_scopes(model)).items()}
    return ({k: float(t.detach()) for k, t in losses.items()},
            {k: float(t) for k, t in jlosses.items()}, grads, jgrads)


def _with_gradient(grads):
    return {n for n, g in grads.items() if np.any(g != 0)}


@pytest.mark.parametrize("ablate", [("nerf", "hoa", "splat"),
                                    ("sample", "nerfcomp"), ("render",)],
                         ids=lambda a: "+".join(a))
def test_ablated_train_step_matches_jax(ablate):
    losses, jlosses, grads, jgrads = _train_step_both(ablate)
    assert set(losses) == set(jlosses)
    assert ("loss_gs_color" in losses) == ("render" not in ablate)
    for k in jlosses:
        np.testing.assert_allclose(losses[k], jlosses[k], rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    assert set(grads) == set(jgrads)
    got, want = _with_gradient(grads), _with_gradient(jgrads)
    assert got == want, (sorted(got - want), sorted(want - got))
    # the seams leave parameters without a gradient (the heads whose
    # outputs they replace by zeros) and keep the rest training
    assert want and set(grads) - want
