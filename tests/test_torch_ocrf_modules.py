"""The port's OcRF modules against their flax counterparts on the CPU.

Each flax module is initialised in JAX; its BatchNorm statistics, scales
and all biases are replaced by random values, the variables are carried
into the port by the weight bridge (strict load) and both run the same
numpy inputs in fp32. JAX modules are NHWC, the port's NCHW (the MLPs
over voxel features stay channel-last in both). Tolerance: rtol 1e-4 /
atol 1e-4 of the output scale (fp32 layers in two frameworks sum in
different orders, ~1e-6 relative each), as tests/test_torch_modules.py.
The ConvTranspose mapping (flax 'SAME', kernel = stride -> torch,
spatially flipped) is pinned on its own, against flax and against the
explicit formula.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu.models.ocrf import deform_attn as jda
from ocrfdet_tpu.models.ocrf import fusion as jfu
from ocrfdet_tpu.models.ocrf import heads as jhe
from ocrfdet_tpu.models.ocrf import hoa as jhoa
from ocrfdet_tpu.ops import grid_sample as jgs
from ocrfdet_tpu_torch.config import tiny_config
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.models.ocrf import deform_attn as tda
from ocrfdet_tpu_torch.models.ocrf import fusion as tfu
from ocrfdet_tpu_torch.models.ocrf import heads as the
from ocrfdet_tpu_torch.models.ocrf import hoa as thoa
from ocrfdet_tpu_torch.ops import grid_sample as tgs
from ocrfdet_tpu_torch.utils.weights import (init_weights,
                                             load_flax_variables)


def perturbed(variables, seed=0):
    """numpy copy of flax variables with random BN statistics, BN scales
    and biases."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        return x
    return {k: jax.tree_util.tree_map_with_path(leaf, dict(v))
            for k, v in variables.items()}


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def close(got, want, rtol=1e-4, atol=1e-4):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, np.abs(want).max()))


def run_pair(jmodule, tmodule, jargs, targs, seed=0, **kw):
    """flax init + perturb + apply, bridge into `tmodule`, run both.
    Returns (port output, JAX output)."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in jargs]
    v = perturbed(jmodule.init(jax.random.PRNGKey(seed), *jargs, **kw),
                  seed)
    want = jmodule.apply(v, *jargs, **kw)
    tmodule = load_flax_variables(tmodule, v).eval()
    with torch.no_grad():
        got = tmodule(*targs)
    return got, want


# --------------------------------------------------------------------
# heads
# --------------------------------------------------------------------

def test_mlp2_and_opacity_mlp_match_flax():
    x = _randn(0, 2, 5, 7, 16)
    got, want = run_pair(jhe.MLP2(4, 3), the.MLP2(16, 4, 3), [x],
                         [torch.from_numpy(x)])
    close(got.numpy(), want)
    got, want = run_pair(jhe.OpacityMLP(), the.OpacityMLP(16), [x],
                         [torch.from_numpy(x)])
    close(got.numpy(), want)


def test_sigma_mlp_matches_flax():
    """Two stacked Linears, no inner activation, softplus; the port runs
    it over the channel axis of an NCHW map."""
    x = _randn(1, 2, 6, 9, 16) * 3.0
    got, want = run_pair(jhe.SigmaMLP(4), the.SigmaMLP(16), [x], [nchw(x)])
    close(nhwc(got), want)


def test_resize_network_matches_flax():
    x = _randn(2, 2, 3, 4, 24)
    got, want = run_pair(jhe.ResizeNetwork(16), the.ResizeNetwork(24, 16),
                         [x], [nchw(x)])
    assert got.shape == (2, 16, 48, 64)
    close(nhwc(got), want)


@pytest.mark.parametrize("k", [2, 4])
def test_conv_transpose_bridge(k):
    """flax ConvTranspose (kernel (k,k) (in,out), stride k, 'SAME') ==
    torch ConvTranspose2d with the bridged (spatially flipped) weight,
    and both == out[k*m + r] = sum_i x[m, i] * K[k-1-r, i, o] + b."""
    x = _randn(3 + k, 2, 3, 5, 6)
    got, want = run_pair(fnn.ConvTranspose(4, (k, k), strides=(k, k)),
                         torch.nn.ConvTranspose2d(6, 4, k, stride=k),
                         [x], [nchw(x)])
    close(nhwc(got), want)
    v = fnn.ConvTranspose(4, (k, k), strides=(k, k)).init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    K, b = np.asarray(v["kernel"]), np.asarray(v["bias"])
    y = np.asarray(fnn.ConvTranspose(4, (k, k), strides=(k, k)).apply(
        {"params": v}, jnp.asarray(x)))
    r, c = 1, k - 1                       # one output phase, by hand
    by_hand = np.einsum("bhwi,io->bhwo", x, K[k - 1 - r, k - 1 - c]) + b
    np.testing.assert_allclose(y[:, r::k, c::k], by_hand, rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------
# fusion
# --------------------------------------------------------------------

def test_ms_cam_and_dual_fusion_match_flax():
    x1, x2 = _randn(4, 2, 8, 8, 16), _randn(5, 2, 8, 8, 16)
    x = np.concatenate([x1, x2], -1)
    got, want = run_pair(jfu.MS_CAM(16), tfu.MS_CAM(32, 16), [x],
                         [nchw(x)], train=False)
    close(nhwc(got), want)
    got, want = run_pair(jfu.DualFeatFusion(16), tfu.DualFeatFusion(16),
                         [x1, x2], [nchw(x1), nchw(x2)], train=False)
    close(nhwc(got), want)


def test_channel_spatial_attention_and_cbam_match_flax():
    x = _randn(6, 2, 8, 8, 32)
    got, want = run_pair(jfu.ChannelAttention(32),
                         tfu.ChannelAttention(32, 32), [x], [nchw(x)])
    close(nhwc(got), want)
    got, want = run_pair(jfu.SpatialAttention(), tfu.SpatialAttention(),
                         [x], [nchw(x)])
    close(nhwc(got), want)
    got, want = run_pair(jfu.ResCBAMBlock(32), tfu.ResCBAMBlock(32), [x],
                         [nchw(x)], train=False)
    close(nhwc(got), want)


def test_prob_net_and_gates_match_flax():
    x = _randn(7, 2, 8, 8, 16)
    logit = _randn(8, 2, 8, 8, 1)
    got, want = run_pair(jfu.ProbNet(16), tfu.ProbNet(16), [x], [nchw(x)],
                         train=False)
    close(nhwc(got), want)
    for jm, tm in ((jfu.BEVGeomAttention(), tfu.BEVGeomAttention()),
                   (jfu.OpacityMask(), tfu.OpacityMask())):
        got, want = run_pair(jm, tm, [x, logit], [nchw(x), nchw(logit)])
        close(nhwc(got), want)


def test_learned_positional_encoding_matches_flax():
    got, want = run_pair(jfu.LearnedPositionalEncoding(8, 6, 7),
                         tfu.LearnedPositionalEncoding(8, 6, 7), [2], [2])
    assert got.shape == (2, 16, 6, 7)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


# --------------------------------------------------------------------
# HOA
# --------------------------------------------------------------------

@pytest.mark.parametrize("c", [4, 16])
def test_height_attention_matches_flax(c):
    x = _randn(9 + c, 2, 8, 8, c)
    got, want = run_pair(jhoa.HeightAttention(), thoa.HeightAttention(c),
                         [x], [nchw(x)])
    close(nhwc(got), want)


def test_conv_block_matches_flax():
    """Depthwise 3x3 (flax feature_group_count) + pointwise + BN."""
    x = _randn(10, 2, 8, 8, 5)
    got, want = run_pair(jhoa._ConvBlock(8), thoa._ConvBlock(5, 8), [x],
                         [nchw(x)], train=False)
    close(nhwc(got), want)


@pytest.mark.parametrize("zh,hw", [(5, 16), (13, 32)])
def test_opacity_voxel_to_bev_matches_flax(zh, hw):
    x = _randn(11, 2, hw, hw, zh)
    pos = np.random.default_rng(12).random((2, hw, hw, 4)).astype(
        np.float32)
    got, want = run_pair(jhoa.OpacityVoxelToBEV(),
                         thoa.OpacityVoxelToBEV(zh), [x, pos],
                         [nchw(x), nchw(pos)], train=False)
    assert got.shape == (2, 1, hw, hw)
    close(nhwc(got), want)


# --------------------------------------------------------------------
# deformable attention
# --------------------------------------------------------------------

def test_cpb_matches_flax():
    rng = np.random.default_rng(13)
    gq = rng.uniform(-1, 1, (30, 2)).astype(np.float32)
    gkv = rng.uniform(-1.5, 1.5, (2, 7, 2)).astype(np.float32)
    got, want = run_pair(jda.CPB(3), tda.CPB(3), [gq, gkv],
                         [torch.from_numpy(gq), torch.from_numpy(gkv)])
    close(got.numpy(), want)


def test_grid_sample_2d_matches_jax():
    img = _randn(14, 2, 7, 9, 3)
    grid = np.random.default_rng(15).uniform(-1.3, 1.3, (2, 4, 5, 2)) \
        .astype(np.float32)
    for ac in (False, True):
        want = jax.vmap(lambda im, g: jgs.grid_sample_2d(
            im, g, align_corners=ac))(jnp.asarray(img), jnp.asarray(grid))
        got = tgs.grid_sample_2d(nchw(img), torch.from_numpy(grid),
                                 align_corners=ac)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("dim,hw", [(5, 8), (13, 21)],
                         ids=["tiny_8x8", "flagship_21x21"])
def test_deformable_attention_matches_flax(dim, hw):
    """dim = num_height, 1 head of 8, offsets from a depthwise 6x6
    stride-4 conv (2x2 and 5x5 offset grids), tanh-approximate gelu."""
    xq = _randn(16, 2, hw, hw, dim)
    xkv = np.random.default_rng(17).random((2, hw, hw, dim)).astype(
        np.float32)
    got, want = run_pair(
        jda.DeformableAttention2D(dim=dim, dim_head=8, heads=1,
                                  downsample_factor=4, offset_scale=4.0,
                                  offset_kernel_size=6),
        tda.DeformableAttention2D(dim), [xq, xkv], [nchw(xq), nchw(xkv)],
        train=False)
    close(nhwc(got), want)


def test_init_weights_covers_the_ocrf_parameters():
    """Seeded init: flax's inits for the raw parameters (height_w
    normal(1), height_b 0, embeddings uniform[0,1)), lecun-normal
    transposed-conv kernels with flax's fan-in (in x kh x kw)."""
    model = init_weights(OcRFDet(tiny_config(with_ocrf=True)), seed=0)
    vt = model.img_view_transformer
    assert not torch.equal(vt.height_w, torch.ones_like(vt.height_w))
    assert torch.count_nonzero(vt.height_b) == 0
    for emb in (vt.pos_enc.row_embed.detach(),
                vt.pos_enc.col_embed.detach()):
        assert 0.0 <= float(emb.min()) and float(emb.max()) < 1.0
        assert float(emb.std()) > 0.1
    w = vt.image_feat_resize.up1.weight.detach()  # (128, 64, 2, 2)
    std = float(w.std())
    assert 0.5 < std * np.sqrt(128 * 4) < 1.5
    again = init_weights(OcRFDet(tiny_config(with_ocrf=True)), seed=0)
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
