"""GeoEnhDet in the port (ocrfdet_tpu_torch/models/geoenh.py) against the
JAX package's on the CPU, in fp32, at the tiny config with the miniature
teacher of tests/test_geoenh.py (embed 32, depth 2, 4 heads, a DINOv2
embedder of depth 2 on a native 2 x 2 grid, teacher images 28 x 56).

* the antialiased bilinear resize against `jax.image.resize` on a
  shrinking and a growing side: rtol 1e-5, atol 1e-5 of the scale
  (measured ~1e-7 of the scale);
* `CrossAttentionAlign` (JAX's init moved by a seeded normal, through the
  weight bridge's 3-D attention kernels), `group_corr_cost_volume` and
  `smooth_l1`: rtol 1e-5, atol 1e-5 of the scale;
* the train-mode forward of the whole model, from the same random
  weights (the shapes of JAX's init, its values drawn here, as
  tests/test_torch_train_step.py does, since compiling JAX's init of the
  whole detector costs a minute) and the same training batch (seed 0,
  batch 2). The depth net's stereo branch is off, as in that test: JAX's
  CPU cost volume interpolates in bf16 (the KD branch does not read the
  cost volume). Both KD losses rtol 1e-4 (measured 1e-7); the
  detector's outputs rtol 1e-3, atol 1e-3 of their scale, as the train
  step's losses (train-mode BatchNorm's batch statistics; measured
  <= 1.4e-4 of the scale);
* the gradient of the sum of the KD losses with respect to every aligner
  tensor against `jax.grad`: relative L2 error <= 1e-4 of each tensor
  (measured <= 9e-6), the key biases' zero gradient floored; it is
  non-zero for the image backbone, and the teacher gets none (no
  `.grad`, and JAX's is exactly 0);
* one tiny training step of the port alone (stereo on): the teacher
  bitwise unchanged, no optimizer moments and no EMA for it, the EMA
  and raw eval models (the student alone), and a save and resume that
  continue bit for bit;
* `Trainer.init_state` grafting a checkpoint in the released layout onto
  the teacher, and `save` keeping it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.data.synthetic import make_batch as jmake_batch
from ocrfdet_tpu.models import geoenh as jgeoenh
from ocrfdet_tpu.models.fpn import resize_bilinear as jresize
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.models import geoenh
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.models.fpn import resize_bilinear_antialiased
from ocrfdet_tpu_torch.train.evaluate import ema_detector, raw_detector
from ocrfdet_tpu_torch.train.step import train_step
from ocrfdet_tpu_torch.utils.weights import load_flax_variables

KD_KEYS = ("loss_Smoothl1_KD", "loss_cos_KD")
AUX_KEYS = ("depth", "semantic", "bev_mask_logit", "opacity_bev_logit")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-5, atol=1e-5, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _teacher(mod):
    return mod.VGGTTeacherConfig(
        image_size=(28, 56), patch_size=14, embed_dim=32, depth=2,
        num_heads=4, patch_embed="dinov2", vit_depth=2, vit_native_grid=2)


def _config(mod, stereo=False):
    c = mod.tiny_config(vggt_teacher=_teacher(mod))
    if stereo:
        return c
    return dataclasses.replace(
        c, use_stereo=False, vt=dataclasses.replace(
            c.vt, depthnet=dataclasses.replace(c.vt.depthnet, stereo=False)))


@pytest.mark.parametrize("hw,out", [((64, 176), (28, 56)),
                                    ((16, 44), (21, 37)),
                                    ((4, 11), (9, 23))],
                         ids=["shrink", "grow_h_shrink_w", "grow"])
def test_antialiased_resize_matches_jax(hw, out):
    x = np.random.default_rng(0).normal(size=(2, *hw, 5)).astype(np.float32)
    _close(resize_bilinear_antialiased(torch.from_numpy(x), out),
           jresize(jnp.asarray(x), out, align_corners=False))


def test_aligner_matches_jax():
    """Student features [2, 4, 11, 64] -> teacher tokens [2, 2, 4, 64]:
    8 heads of 8 over 44 queries and 8 keys, then the resize to 2 x 4."""
    rng = np.random.default_rng(1)
    res = rng.normal(size=(2, 4, 11, 64)).astype(np.float32)
    vit = rng.normal(size=(2, 2, 4, 64)).astype(np.float32)
    jmod = jgeoenh.CrossAttentionAlign(vit_dim=64)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(res),
                       jnp.asarray(vit))["params"]
    params = jax.tree.map(lambda x: (np.asarray(x) + rng.normal(
        0.0, 0.05, x.shape)).astype(np.float32), params)
    assert params["attn"]["query"]["kernel"].shape == (64, 8, 8)
    assert params["attn"]["out"]["kernel"].shape == (8, 8, 64)
    want = jmod.apply({"params": params}, jnp.asarray(res), jnp.asarray(vit))
    tmod = load_flax_variables(geoenh.CrossAttentionAlign(64, 64),
                               {"params": params})
    with torch.no_grad():
        got = tmod(torch.from_numpy(res), torch.from_numpy(vit))
    assert got.shape == (2, 2, 4, 64)
    _close(got, want)


def test_group_corr_and_smooth_l1_match_jax():
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(2, 2, 3, 8, 64)).astype(np.float32)
    want = jgeoenh.group_corr_cost_volume(jnp.asarray(feats), 4, 16)
    got = geoenh.group_corr_cost_volume(torch.from_numpy(feats), 4, 16)
    assert got.shape == (2, 3, 8, 5, 16)
    _close(got, want)
    x, y = (rng.normal(0, 2, size=(1000,)).astype(np.float32)
            for _ in range(2))
    _close(geoenh.smooth_l1(torch.from_numpy(x), torch.from_numpy(y)),
           jgeoenh.smooth_l1(jnp.asarray(x), jnp.asarray(y)))


def random_variables(shapes, seed=0):
    """numpy variables for the shapes of a flax init: lecun truncated
    normal kernels, random LayerNorm/BatchNorm scales and biases, the
    OcRF raw parameters at their inits' scale and the VGGT layer scales,
    tokens and position embedding random."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name, shape = path[-1].key, x.shape
        if name == "kernel":
            fan_in = np.prod(shape[:-1])
            if len(shape) == 3:        # flax attention's DenseGeneral
                fan_in = (np.prod(shape[:2]) if path[-2].key == "out"
                          else shape[0])
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
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
        elif name in ("row_embed", "col_embed", "ls1", "ls2"):
            v = rng.uniform(0.0, 1.0, shape)
        elif name == "w":
            v = np.full(shape, 0.5)
        elif name in ("cls_token", "register_tokens", "pos_embed",
                      "camera_token", "register_token"):
            v = rng.normal(0.0, 0.1, shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)
    return {k: jax.tree_util.tree_map_with_path(leaf, dict(v))
            for k, v in shapes.items()}


@pytest.fixture(scope="module")
def run():
    jcfg, cfg = _config(jconfig), _config(tconfig)
    jm = jgeoenh.GeoEnhDet(jcfg)
    jb = jax.tree.map(jnp.asarray, jmake_batch(jcfg, batch_size=2, seed=0))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb,
                                            train=True))
    v = random_variables({"params": shapes["params"],
                          "batch_stats": shapes["batch_stats"]})

    def kd(params, b):
        (preds, aux), _ = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, b,
            train=True, mutable=["batch_stats"])
        return aux["loss_Smoothl1_KD"] + aux["loss_cos_KD"], (preds, aux)
    (_, (jpreds, jaux)), jgrads = jax.jit(jax.value_and_grad(
        kd, has_aux=True))(v["params"], jb)

    model = load_flax_variables(geoenh.GeoEnhDet(cfg, render_heads=True),
                                v).train()
    batch = entry.make_batch(cfg, seed=0, batch_size=2, device="cpu",
                             with_targets=True)
    preds, aux = model(batch)
    (aux["loss_Smoothl1_KD"] + aux["loss_cos_KD"]).backward()
    return dict(jpreds=jpreds, jaux=jaux, jgrads=jax.tree.map(
        np.asarray, jgrads), preds=preds, aux=aux, model=model)


def test_kd_losses_match_jax(run):
    for k in KD_KEYS:
        assert np.isfinite(float(run["aux"][k].detach()))
        _close(run["aux"][k].detach(), run["jaux"][k], rtol=1e-4, atol=0,
               msg=k)


def test_train_forward_outputs_match_jax(run):
    pairs = [(f"task{t}/{k}", tp[k], jp[k]) for t, (tp, jp) in
             enumerate(zip(run["preds"], run["jpreds"])) for k in tp]
    pairs += [(k, run["aux"][k], run["jaux"][k]) for k in AUX_KEYS]
    for name, got, want in pairs:
        assert tuple(got.shape) == want.shape, name
        _close(got.detach(), want, rtol=1e-3, atol=1e-3, msg=name)
    assert "fpn_key" not in run["aux"]


def test_kd_gradients_match_jax(run):
    """Every aligner tensor's gradient against jax.grad of the KD sum;
    the backbone gets one, the frozen teacher none."""
    model = run["model"]
    g = run["jgrads"]
    aligner = g["aligner"]
    flat = {"query_proj": aligner["query_proj"],
            "key_proj": aligner["key_proj"],
            "value_proj": aligner["value_proj"],
            "output_proj": aligner["output_proj"],
            **{f"attn.{n}": aligner["attn"][n]
               for n in ("query", "key", "value", "out")}}
    pairs = []
    for name, leaves in flat.items():
        mod = model.aligner.get_submodule(name)
        for leaf, p in (("kernel", mod.weight), ("bias", mod.bias)):
            want = leaves[leaf]
            if leaf == "kernel":
                want = (want.reshape(-1, want.shape[-1]) if name == "attn.out"
                        else want.reshape(want.shape[0], -1)).T
            got = p.grad.numpy().reshape(want.shape)
            pairs.append((name, leaf, got, want))
    # the key projections' biases have a gradient of exactly 0 in exact
    # arithmetic (a softmax ignores a logit shift shared by every key):
    # theirs is rounding noise, so the norm is floored at 1e-3 of the
    # mean tensor norm
    floor = 1e-3 * np.mean([np.linalg.norm(w) for *_, w in pairs])
    for name, leaf, got, want in pairs:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), floor)
        assert err <= 1e-4, (name, leaf, err)
    assert sum(float(p.grad.abs().sum()) for p in
               model.img_backbone.parameters() if p.grad is not None) > 0
    assert all(p.grad is None for p in model.aggregator.parameters())
    assert all(not np.any(x) for x in jax.tree.leaves(g["aggregator"]))


def test_training_step_freezes_the_teacher_and_resumes(tmp_path):
    cfg = _config(tconfig, stereo=True)
    state = entry.build_trainer(cfg, "cpu", seed=0)
    teacher = {n: p.detach().clone()
               for n, p in state.model.aggregator.named_parameters()}
    batches = [entry.make_batch(cfg, seed=s, batch_size=2, device="cpu",
                                with_targets=True) for s in (0, 1)]
    m1 = train_step(state, batches[0])
    assert m1["skipped_nonfinite"] == 0.0 and state.step == 1
    assert all(np.isfinite(m1[k]) for k in KD_KEYS)
    for n, p in state.model.aggregator.named_parameters():
        assert torch.equal(p, teacher[n]) and not p.requires_grad, n
    sd = state.state_dict()
    assert not any(k.split(".", 1)[1].startswith("aggregator.")
                   for k in sd["optimizer"])
    assert not any(k.startswith("aggregator.") for k in sd["ema_params"])
    assert any(k.startswith("aligner.") for k in sd["ema_params"])
    assert any(k.startswith("aggregator.") for k in sd["model"])
    assert any(v.abs().sum() > 0 for k, v in sd["optimizer"].items()
               if k.split(".", 1)[1].startswith("aligner."))

    # the eval models: the student alone, holding the EMA or the raw
    # weights
    model = ema_detector(cfg, state, device="cpu")
    assert type(model) is OcRFDet and not hasattr(model, "aggregator")
    ema = dict(sd["ema_params"], **sd["ema_stats"])
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ema[k]), k
    raw = raw_detector(cfg, state)
    assert type(raw) is OcRFDet and not hasattr(raw, "aligner")
    for k, v in raw.state_dict().items():
        assert torch.equal(v, sd["model"][k]), k

    # save, a second step, and the same step from a fresh state resumed
    path = tmp_path / "ckpt.pt"
    torch.save(sd, path)
    m2 = train_step(state, batches[1])
    resumed = entry.build_trainer(cfg, "cpu", seed=1)
    resumed.load_state_dict(torch.load(path))
    assert train_step(resumed, batches[1]) == m2
    a, b = state.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 2
    assert torch.equal(a.pop("generator"), b.pop("generator"))
    for part in ("model", "optimizer", "ema_params", "ema_stats"):
        assert a[part].keys() == b[part].keys(), part
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


def test_trainer_grafts_the_released_teacher(tmp_path, capsys):
    """With `vggt_teacher.ckpt_path`, `Trainer.init_state` loads the
    released checkpoint's aggregator into the frozen teacher (the
    miniature released layout of tests/test_torch_vggt.py), and a
    checkpoint holds it."""
    from test_torch_vggt import _released_sd
    from ocrfdet_tpu_torch.train.trainer import Trainer

    sd = _released_sd(np.random.default_rng(5))
    path = tmp_path / "vggt.pt"
    torch.save({"aggregator." + k: torch.from_numpy(v)
                for k, v in sd.items()}, path)
    cfg = _config(tconfig)
    cfg = dataclasses.replace(cfg, vggt_teacher=dataclasses.replace(
        cfg.vggt_teacher, ckpt_path=str(path)))
    trainer = Trainer(cfg, str(tmp_path / "work"), 1, device="cpu")
    trainer.init_state()
    agg = trainer.state.model.aggregator
    assert torch.equal(agg.global_block1.mlp_fc2.weight,
                       torch.from_numpy(sd["global_blocks.1.mlp.fc2.weight"]))
    assert torch.equal(agg.patch_embed.pos_embed,
                       torch.from_numpy(sd["patch_embed.pos_embed"]))
    assert torch.equal(agg.camera_token, torch.from_numpy(
        sd["camera_token"][0]))
    trainer.save(0)
    saved = torch.load(tmp_path / "work" / "ckpt_epoch_0.pt")
    assert torch.equal(saved["model"]["aggregator.frame_block0.ls1"],
                       torch.from_numpy(sd["frame_blocks.0.ls1.gamma"]))
    out = capsys.readouterr().out
    assert "loaded VGGT teacher weights" in out and "GB in" in out
