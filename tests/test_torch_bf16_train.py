"""The bf16 training forward: the tiny OcRF config with
`compute_dtype="bfloat16"` in train mode (render branch included)
through the port and the JAX package on the CPU, from the same weights
and training batch (tests/test_torch_train_stereo.py's: JAX's init
shapes with random values, seed 0, batch 2), and its loss dict held
against JAX's with the method of tests/test_torch_bf16.py.

Stereo is on, with JAX's cost volumes replayed in both packages, as
test_torch_train_stereo.py replays them: JAX's CPU cost volume taps in
bf16 even in an fp32 run, which alone moves this step's losses by up to
40%. Each dtype replays the volumes of JAX's own forward in that dtype.

The port runs three times in bf16: under CPU autocast (which keeps the
ops below in bf16, as flax does), under `CardPolicy` (the ops that CUDA
autocast computes in fp32 upcast, as on the card), and in fp32. The
training forward reaches these upcasts (tests/test_torch_bf16.py's
list): in each of the two temporal frames the deformable attention's
softmax and the `SigmaMLP` softplus, and in the key frame's render
branch the NeRF render's two factor softmaxes, the `ScaleMLP` softplus
and the quaternion normalisation's sum of squares (its rsqrt then takes
the upcast fp32 sum, so it is not counted).

Tolerance, per group of losses (the heads' 36, the depth, semantic and
BEV mask losses, the three render losses), as tests/test_torch_bf16.py
per output: the spread is the larger of the two packages' distance
between their own bf16 and fp32 losses, the RMS over the group of
|bf16 - fp32| / max(1, |fp32|); the port's bf16 losses, under either
policy, are held to JAX's within sqrt(2) x the spread. (A single loss
is one draw of the rounding noise: two independent draws differ by more
than sqrt(2) x the larger of them often, so losses are held by group.)
Measured: spreads 1.1e-3 (BEV), 1.6e-2 (render), 6.7e-2 (heads), the
port's distance to JAX 1.16, 0.41 and 1.14 times the spread, under
either policy: the card's policy moves the render losses by ~6e-5 of
their scale and nothing else, so no op of the port changed. The fp32
losses agree to rtol 1e-2 (test_torch_train_stereo.py's bound with the
volumes replayed; measured 2e-4 RMS).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import CardPolicy
from test_torch_train_step import random_variables
from test_torch_train_stereo import _replay

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.data.synthetic import make_batch as jmake_batch
from ocrfdet_tpu.models import detector as jdetector
from ocrfdet_tpu.models.depthnet import \
    stereo_cost_volume as jstereo_cost_volume
from ocrfdet_tpu.models.detector import OcRFDet as JaxOcRFDet
from ocrfdet_tpu.train.trainstep import compute_losses as jcompute_losses
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.models import detector as tdetector
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.train.trainstep import compute_losses
from ocrfdet_tpu_torch.utils.weights import load_flax_variables


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_losses(dtype):
    """JAX's loss dict and its cost volumes, for `dtype`."""
    jcfg = jconfig.tiny_config(compute_dtype=dtype)
    assert jcfg.use_stereo and jcfg.vt.depthnet.stereo
    jm = JaxOcRFDet(jcfg)
    jb = jax.tree.map(jnp.asarray, jmake_batch(jcfg, batch_size=2, seed=0))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb,
                                            train=True))
    v = random_variables({"params": shapes["params"],
                          "batch_stats": shapes["batch_stats"]})
    recorded = []

    def record(*args, **kw):
        out = jstereo_cost_volume(*args, **kw)
        recorded.append(out)
        return out

    def losses(params, b):
        recorded.clear()
        (preds, aux), _ = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, b,
            train=True, mutable=["batch_stats"])
        return jcompute_losses(jcfg, preds, aux, b), list(recorded)
    with mock.patch.object(jdetector, "stereo_cost_volume", record):
        jl, cvs = jax.jit(losses)(v["params"], jb)
    return ({k: float(t) for k, t in jl.items()},
            [np.array(c, np.float32) for c in cvs], v)


def _port_losses(dtype, v, cvs, policy=None):
    cfg = tconfig.tiny_config(compute_dtype=dtype)
    model = load_flax_variables(OcRFDet(cfg, render_heads=True), v).train()
    batch = entry.make_batch(cfg, seed=0, batch_size=2, device="cpu",
                             with_targets=True)
    replay = _replay([torch.from_numpy(c) for c in cvs])
    with torch.no_grad(), mock.patch.object(
            tdetector, "stereo_cost_volume", replay):
        if policy is None:
            preds, aux = model(batch)
        else:
            with policy:
                preds, aux = model(batch)
        losses = compute_losses(cfg, preds, aux, batch)
    assert replay.calls == len(cvs) == 2
    return {k: float(t) for k, t in losses.items()}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jl, cvs, v = _jax_losses(dtype)
        out[f"jax_{dtype}"] = jl
        out[f"port_{dtype}"] = _port_losses(dtype, v, cvs)
    policy = CardPolicy()
    out["card_bfloat16"] = _port_losses("bfloat16", v, cvs, policy)
    out["upcast"] = dict(policy.upcast)
    return out


def test_card_policy_upcasts_the_render_branch(runs):
    """The eval forward's two upcasts in each frame, and the render
    branch's two softmaxes, softplus and sum of squares in the key
    frame."""
    assert runs["upcast"] == {"softmax": 2 + 2, "softplus": 2 + 1,
                              "sum": 1}


def _groups(keys):
    heads = [k for k in keys if k.startswith("task")]
    render = [k for k in keys
              if k in ("loss_gs_color", "loss_gs_ssim", "loss_render_depth")]
    return dict(heads=heads, render=render, bev=[
        k for k in keys if k not in heads and k not in render])


@pytest.mark.parametrize("port", ["port_bfloat16", "card_bfloat16"])
def test_bf16_train_losses_match_jax_within_the_spread(runs, port):
    j32, j16 = runs["jax_float32"], runs["jax_bfloat16"]
    t32, t16 = runs["port_float32"], runs[port]
    assert set(t16) == set(j16) == set(t32)
    for k in j16:
        np.testing.assert_allclose(t32[k], j32[k], rtol=1e-2, atol=1e-6,
                                   err_msg=k)
    groups = _groups(sorted(j16))
    assert len(groups["heads"]) == 36 and len(groups["render"]) == 3
    for name, keys in groups.items():
        def vec(run):
            return np.array([run[k] for k in keys])
        scale = np.maximum(1.0, np.abs(vec(j32)))

        def rms(a, b):
            return float(np.sqrt(np.mean(((vec(a) - vec(b)) / scale) ** 2)))
        spread = max(rms(j16, j32), rms(runs["port_bfloat16"], t32))
        assert spread > 1e-4, name          # bf16 really ran
        got = rms(t16, j16)
        assert got <= np.sqrt(2.0) * spread, (name, got, spread)
