"""GeoEnhDet's bf16 teacher: the miniature VGGT teacher (depth 1, a
DINOv2 embedder of depth 1, embed 32, 4 heads, the released input size
294 x 518: 21 x 37 patches a frame) of tests/test_torch_isolation.py,
its tokens and the two KD losses of `kd_branch` (models/geoenh.py), in
the port and the JAX package on the CPU, from the same weights (JAX's
init shapes, values drawn as tests/test_torch_geoenh.py draws them), the
same teacher images and the same student features.

The two dtype policies differ (ROADMAP fault (d)(ii)). flax rounds
every VGGT LayerNorm's output to bf16 (norm1, norm2 and the QK-norms)
and forms the attention logits in fp32 (its fp32 RoPE tables promote q
and k); the port runs the blocks under autocast, where CUDA computes
LayerNorm in fp32, and casts q and k to bf16 after RoPE for SDPA. The
port runs under CPU autocast and under `CardPolicy`
(tests/test_torch_bf16.py: the ops CUDA autocast computes in fp32
upcast, LayerNorm among them).

Tolerance, as tests/test_torch_bf16.py: per output (the tokens; the two
KD losses as one output), the spread is the larger of the two
packages' relative RMS distance between their own bf16 and fp32
outputs (to max(1, max |fp32|)), and the port's bf16 output is held to
JAX's within sqrt(2) x the spread. The fp32 outputs agree to 1e-5
(tokens) and 1e-4 (KD losses, test_torch_geoenh.py's rtol).

Measured: spreads 8.4e-4 (tokens) and 1.1e-3 (KD losses); the port's
distance to JAX 0.82 and 0.41 times the spread under CPU autocast, 0.82
and 0.43 under the card's policy. Both dtype policies stay within the
bound, so the port keeps its LayerNorms in fp32 and SDPA's bf16 path.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import CardPolicy
from test_torch_geoenh import random_variables

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.models import geoenh as jgeoenh
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch.models import geoenh
from ocrfdet_tpu_torch.models.view_transformer import towers_autocast
from ocrfdet_tpu_torch.utils.weights import load_flax_variables

KD_KEYS = ("loss_Smoothl1_KD", "loss_cos_KD")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(mod, dtype):
    return mod.tiny_config(compute_dtype=dtype, vggt_teacher=(
        mod.VGGTTeacherConfig(depth=1, vit_depth=1, embed_dim=32,
                              num_heads=4)))


def _inputs(cfg):
    """Teacher images [2, 2, 294, 518, 3], student features (channel-
    last [2, 6, h, w, C]) and a batch holding the key frame's images and
    the camera pairs."""
    rng = np.random.default_rng(0)
    H, W = cfg.data.input_size
    N, C = 6, cfg.vt.in_channels
    th, tw = cfg.vggt_teacher.image_size
    return dict(
        timgs=rng.normal(size=(2, 2, th, tw, 3)).astype(np.float32),
        fpn=rng.normal(size=(2, N, H // 16, W // 16, C)).astype(np.float32),
        imgs=rng.normal(size=(2, 1, N, H, W, 3)).astype(np.float32),
        kd_pair=np.array([[0, 1], [4, 5]], np.int32))


def _jax(dtype, x, variables=None):
    jcfg = _config(jconfig, dtype)
    jm = jgeoenh.GeoEnhDet(jcfg)
    batch = dict(imgs=jnp.asarray(x["imgs"]),
                 kd_pair=jnp.asarray(x["kd_pair"]))
    fpn = jnp.asarray(x["fpn"])
    kd = jgeoenh.GeoEnhDet.kd_branch
    if variables is None:
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), fpn, batch, True, method=kd))
        variables = random_variables({"params": shapes["params"]})

    def teacher(m, imgs):
        return m.aggregator(imgs.astype(m.dtype))[0]
    tokens = jax.jit(lambda v, i: jm.apply(v, i, method=teacher))(
        variables, jnp.asarray(x["timgs"]))
    losses = jax.jit(lambda v, f, b: jm.apply(v, f, b, True, method=kd))(
        variables, fpn, batch)
    return dict(tokens=np.asarray(tokens, np.float32),
                kd=np.array([float(losses[k]) for k in KD_KEYS])), variables


def _port(dtype, x, variables, policy=None):
    cfg = _config(tconfig, dtype)
    model = geoenh.GeoEnhDet(cfg)
    for part in ("aggregator", "aligner"):
        load_flax_variables(getattr(model, part),
                            {"params": variables["params"][part]})
    batch = dict(imgs=torch.from_numpy(x["imgs"]),
                 kd_pair=torch.from_numpy(x["kd_pair"]))
    fpn = torch.from_numpy(x["fpn"]).permute(0, 1, 4, 2, 3)
    with torch.no_grad(), (policy or contextlib.nullcontext()):
        with towers_autocast(fpn.device, model.dtype):
            tokens, _ = model.aggregator(
                torch.from_numpy(x["timgs"]).to(model.dtype))
        losses = model.kd_branch(fpn, batch)
    return dict(tokens=tokens.float().numpy(),
                kd=np.array([float(losses[k]) for k in KD_KEYS]))


@pytest.fixture(scope="module")
def runs():
    x = _inputs(_config(tconfig, "float32"))
    out = {}
    out["jax_float32"], v = _jax("float32", x)
    out["jax_bfloat16"], _ = _jax("bfloat16", x, v)
    out["port_float32"] = _port("float32", x, v)
    out["port_bfloat16"] = _port("bfloat16", x, v)
    policy = CardPolicy()
    out["card_bfloat16"] = _port("bfloat16", x, v, policy)
    out["upcast"] = dict(policy.upcast)
    return out


def _rms(a, b, scale):
    return float(np.sqrt(np.mean((a - b) ** 2))) / scale


def test_card_policy_upcasts_the_teacher_layer_norms(runs):
    """On the card only the LayerNorms leave bf16 (SDPA keeps its
    softmax inside; the KD costs run in fp32 outside autocast)."""
    assert set(runs["upcast"]) == {"layer_norm"}, runs["upcast"]


@pytest.mark.parametrize("port", ["port_bfloat16", "card_bfloat16"])
@pytest.mark.parametrize("out", ["tokens", "kd"])
def test_bf16_teacher_matches_jax_within_the_spread(runs, port, out):
    j32, j16 = runs["jax_float32"][out], runs["jax_bfloat16"][out]
    t32, t16 = runs["port_float32"][out], runs[port][out]
    assert t16.shape == j16.shape
    scale = max(1.0, float(np.abs(j32).max()))
    assert _rms(t32, j32, scale) < (1e-5 if out == "tokens" else 1e-4)
    spread = max(_rms(j16, j32, scale),
                 _rms(runs["port_bfloat16"][out], t32, scale))
    assert spread > 1e-4                  # bf16 really ran
    got = _rms(t16, j16, scale)
    assert got <= np.sqrt(2.0) * spread, (got, spread)
