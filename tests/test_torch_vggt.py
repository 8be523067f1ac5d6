"""The port's VGGT teacher (ocrfdet_tpu_torch/models/vggt.py) against the
JAX package's on the CPU, in fp32, at the miniature teacher of
tests/test_geoenh.py: embed 32, depth 2, 4 heads, a DINOv2 embedder of
depth 2 on a native 2 x 2 grid, images 28 x 56 (2 x 4 patches).

The weights are JAX's init, every leaf moved by a seeded normal (so that
the layer scales, tokens and LayerNorms are not at their constant
inits), carried over by the weight bridge with a strict load. The
released-layout test converts one synthetic numpy state dict with the
released key names into both packages.

Tolerances: the RoPE tables and rotation rtol 1e-6; the bicubic matrix
exactly; the ViT, the aggregator and the converted aggregator rtol 1e-5,
atol 1e-5 of the output's scale (another fp32 summation order in the
attention and the matmuls).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu.models import vggt as jvggt
from ocrfdet_tpu_torch.models import vggt
from ocrfdet_tpu_torch.utils.weights import (flax_to_state_dict,
                                             load_flax_variables,
                                             raw_param_names)

D, HEADS, DEPTH, R, P, NG = 32, 4, 2, 4, 14, 2


def _close(got, want, rtol=1e-5, atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(1.0, np.abs(want).max()))


def _moved(params, seed):
    """numpy copy of flax params, every leaf plus normal(0, 0.05)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x, np.float32) + rng.normal(
        0.0, 0.05, x.shape)).astype(np.float32), params)


def _both(jmod, tmod, x, seed=0):
    """(JAX output, port output, numpy params) of one module on x."""
    params = _moved(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
                    ["params"], seed + 1)
    jout = jmod.apply({"params": params}, jnp.asarray(x))
    load_flax_variables(tmod, {"params": params})
    with torch.no_grad():
        tout = tmod(torch.from_numpy(x))
    return jout, tout, params


def test_rope_tables_and_rotation_match_jax():
    rng = np.random.default_rng(0)
    pos = np.concatenate([np.zeros((5, 2)), np.stack(np.meshgrid(
        np.arange(3), np.arange(4), indexing="ij"), -1).reshape(-1, 2) + 1],
        0).astype(np.float32)
    hd = D // HEADS
    jc, js = jvggt.rope_2d_freqs(hd, jnp.asarray(pos))
    tc, ts = vggt.rope_2d_freqs(hd, torch.from_numpy(pos))
    _close(tc, jc, rtol=1e-6, atol=1e-6)
    _close(ts, js, rtol=1e-6, atol=1e-6)
    x = rng.normal(size=(2, HEADS, len(pos), hd)).astype(np.float32)
    _close(vggt.apply_rope(torch.from_numpy(x), tc, ts),
           jvggt.apply_rope(jnp.asarray(x), jc, js), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_in,n_out", [(37, 21), (37, 37), (2, 4), (5, 9),
                                        (14, 3)])
def test_bicubic_matrix_is_jaxs(n_in, n_out):
    for sf in (None, (n_out + 0.1) / n_in):
        np.testing.assert_array_equal(
            vggt.torch_bicubic_matrix(n_in, n_out, sf),
            jvggt.torch_bicubic_matrix(n_in, n_out, sf))


@pytest.mark.parametrize("hw", [(NG * P, NG * P), (2 * P, 4 * P),
                                (3 * P, 4 * P)],
                         ids=["native_grid", "resized_2x4", "resized_3x4"])
def test_dino_vit_matches_jax(hw):
    x = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    jout, tout, _ = _both(
        jvggt.DinoViT(patch_size=P, embed_dim=D, depth=DEPTH, num_heads=HEADS,
                      num_register_tokens=R, native_grid=NG),
        vggt.DinoViT(P, D, DEPTH, HEADS, R, NG), x)
    assert tout.shape == (2, (hw[0] // P) * (hw[1] // P), D)
    _close(tout, jout)


def _aggregators(patch_embed="dinov2"):
    kw = dict(patch_size=P, embed_dim=D, depth=DEPTH, num_heads=HEADS,
              patch_embed=patch_embed, vit_depth=DEPTH, vit_native_grid=NG)
    return jvggt.Aggregator(**kw), vggt.Aggregator(**kw)


@pytest.mark.parametrize("patch_embed", ["dinov2", "conv"])
def test_aggregator_matches_jax(patch_embed):
    """S = 2 frames of 28 x 56: 1 camera + 4 register + 8 patch tokens
    each, [frame | global] concatenated."""
    x = np.random.default_rng(2).normal(
        size=(2, 2, 2 * P, 4 * P, 3)).astype(np.float32)
    (jtok, jp0), (ttok, tp0), params = _both(*_aggregators(patch_embed), x)
    assert tp0 == jp0 == 1 + R
    assert ttok.shape == (2, 2, 1 + R + 8, 2 * D)
    _close(ttok, jtok)
    # the layer scales and tokens are raw parameters of their modules
    sd = flax_to_state_dict({"params": params},
                            raw_names=raw_param_names(_aggregators()[1]))
    assert {"frame_block0.ls1", "camera_token", "register_token"} <= set(sd)


def test_raw_inits_follow_flax():
    """Seeded init: layer scale 0.01 in the VGGT blocks, 1.0 in the
    DINOv2 blocks; the tokens tiny, the position embedding ~0.02."""
    from ocrfdet_tpu_torch.utils.weights import init_weights
    agg = init_weights(_aggregators()[1], seed=0)
    assert torch.all(agg.frame_block1.ls2 == 0.01)
    assert torch.all(agg.patch_embed.block0.ls1 == 1.0)
    assert 0 < agg.camera_token.abs().max() < 1e-5
    assert 0.015 < float(agg.patch_embed.pos_embed.detach().std()) < 0.025
    assert torch.all(agg.frame_block0.norm1.weight == 1.0)


def _released_sd(rng):
    """A miniature state dict in the released VGGT-1B layout (the
    `aggregator.` prefix stripped), DINOv2 embedder and its mask token
    included."""
    sd = {}

    def put(name, *shape, one=False):
        sd[name] = ((1.0 if one else 0.0)
                    + rng.normal(0, 0.05, shape)).astype(np.float32)

    pe = "patch_embed."
    put(pe + "cls_token", 1, 1, D)
    put(pe + "pos_embed", 1, 1 + NG * NG, D)
    put(pe + "register_tokens", 1, R, D)
    put(pe + "mask_token", 1, D)
    put(pe + "patch_embed.proj.weight", D, 3, P, P)
    put(pe + "patch_embed.proj.bias", D)
    put(pe + "norm.weight", D, one=True)
    put(pe + "norm.bias", D)
    blocks = [(f"{pe}blocks.{i}.", False) for i in range(DEPTH)]
    blocks += [(f"{g}.{i}.", True) for g in ("frame_blocks", "global_blocks")
               for i in range(DEPTH)]
    for b, qk in blocks:
        for n in ("norm1", "norm2"):
            put(b + n + ".weight", D, one=True)
            put(b + n + ".bias", D)
        put(b + "attn.qkv.weight", 3 * D, D)
        put(b + "attn.qkv.bias", 3 * D)
        put(b + "attn.proj.weight", D, D)
        put(b + "attn.proj.bias", D)
        if qk:
            for n in ("q_norm", "k_norm"):
                put(b + f"attn.{n}.weight", D // HEADS, one=True)
                put(b + f"attn.{n}.bias", D // HEADS)
        put(b + "ls1.gamma", D)
        put(b + "ls2.gamma", D)
        put(b + "mlp.fc1.weight", 4 * D, D)
        put(b + "mlp.fc1.bias", 4 * D)
        put(b + "mlp.fc2.weight", D, 4 * D)
        put(b + "mlp.fc2.bias", D)
    put("camera_token", 1, 2, 1, D)
    put("register_token", 1, 2, R, D)
    return sd


def test_released_layout_converts_into_both(tmp_path):
    """One synthetic numpy state dict in the released layout, converted by
    each package (JAX's `convert_torch_state_dict`, the port's
    `load_torch_weights` from a checkpoint file), gives equal forwards."""
    sd = _released_sd(np.random.default_rng(3))
    x = np.random.default_rng(4).normal(
        size=(1, 2, 2 * P, 4 * P, 3)).astype(np.float32)
    jagg, tagg = _aggregators()
    params = jagg.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    jtok, _ = jagg.apply({"params": jvggt.convert_torch_state_dict(
        params, sd)}, jnp.asarray(x))
    path = tmp_path / "model.pt"
    torch.save({"aggregator." + k: torch.from_numpy(v) for k, v in sd.items()}
               | {"camera_head.w": torch.zeros(3)}, path)
    vggt.load_torch_weights(tagg, str(path))
    assert torch.equal(tagg.frame_block1.ls2,
                       torch.from_numpy(sd["frame_blocks.1.ls2.gamma"]))
    with torch.no_grad():
        ttok, _ = tagg(torch.from_numpy(x))
    _close(ttok, jtok)
