"""The port's modules against the JAX package's on the CPU.

Each flax module is initialised in JAX; its BatchNorm statistics,
scales and all biases are then replaced by random values (so that the
BN conversion and every bias are really exercised), the variables are
carried into the port with the weight bridge (strict load), and both
run the same numpy inputs in fp32. Layouts: JAX modules are NHWC, the
port's modules NCHW; tensor functions are channel-last in both.
Tolerances: fp32 convolutions in two frameworks sum in different
orders, ~1e-6 relative per layer; rtol 1e-4 / atol 1e-4 (relative to
the output scale) covers a few dozen layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.core import coder as jcoder
from ocrfdet_tpu.data import synthetic as jsyn
from ocrfdet_tpu.geometry import frustum as jfr
from ocrfdet_tpu.geometry import transforms as jtf
from ocrfdet_tpu.models import centerhead as jch
from ocrfdet_tpu.models import depthnet as jdn
from ocrfdet_tpu.models import fpn as jfpn
from ocrfdet_tpu.models import resnet as jres
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch.core import coder as tcoder
from ocrfdet_tpu_torch.data import synthetic as tsyn
from ocrfdet_tpu_torch.geometry import frustum as tfr
from ocrfdet_tpu_torch.geometry import transforms as ttf
from ocrfdet_tpu_torch.models import centerhead as tch
from ocrfdet_tpu_torch.models import depthnet as tdn
from ocrfdet_tpu_torch.models import fpn as tfpn
from ocrfdet_tpu_torch.models import resnet as tres
from ocrfdet_tpu_torch.utils.weights import (flax_to_state_dict,
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


def jax_run(module, args, seed=0, **kw):
    """init + perturb + apply a flax module; returns (variables, out)."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    v = perturbed(module.init(jax.random.PRNGKey(seed), *jargs, **kw), seed)
    return v, module.apply(v, *jargs, **kw)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def close(got, want, rtol=1e-4, atol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, np.abs(want).max()))


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------------------
# config, synthetic batch, geometry
# --------------------------------------------------------------------

@pytest.mark.parametrize("factory,overrides", [
    ("ocrfdet_config", {}), ("tiny_config", {}),
    ("ocrfdet_config", dict(batch_size=1, with_ocrf=False)),
    ("tiny_config", dict(with_ocrf=False, use_stereo=False))])
def test_config_copy_matches_jax(factory, overrides):
    mine = getattr(tconfig, factory)(**overrides)
    ref = getattr(jconfig, factory)(**overrides)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (mine.num_frames, mine.total_frames) == (ref.num_frames,
                                                    ref.total_frames)


@pytest.mark.parametrize("stereo", [True, False])
def test_make_batch_matches_jax(stereo):
    """The eval batch equals JAX's on its keys; the training batch has
    JAX's keys and equals it on every one."""
    cfg = tconfig.tiny_config(use_stereo=stereo)
    jcfg = jconfig.tiny_config(use_stereo=stereo)
    mine = tsyn.make_batch(cfg, batch_size=2, seed=3)
    ref = jsyn.make_batch(jcfg, batch_size=2, seed=3, with_targets=False)
    for k, v in mine.items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    mine = tsyn.make_batch(cfg, batch_size=2, seed=3, with_targets=True)
    ref = jsyn.make_batch(jcfg, batch_size=2, seed=3, with_targets=True)
    assert set(mine) == set(ref)
    for k, v in mine.items():
        np.testing.assert_equal(v, ref[k], err_msg=k)


def test_frustum_templates_match_jax():
    for depth_cfg, size, ds in (((1.0, 60.0, 0.5), (256, 704), 16),
                                ((1.0, 60.0, 0.5), (256, 704), 4),
                                ((1.0, 33.0, 2.0), (64, 176), 16)):
        np.testing.assert_array_equal(tfr.sid_depth_bins(depth_cfg),
                                      jfr.sid_depth_bins(depth_cfg))
        np.testing.assert_array_equal(tfr.make_frustum(depth_cfg, size, ds),
                                      jfr.make_frustum(depth_cfg, size, ds))


def _aug_cams(seed, B=2, N=3):
    """Synthetic rig with random image and BEV augmentation."""
    cfg = tconfig.tiny_config()
    b = tsyn.make_batch(cfg, batch_size=B, seed=seed)
    rng = np.random.default_rng(seed)
    th = rng.uniform(-0.1, 0.1, (B, N))
    pr = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    pr[..., 0, 0] = np.cos(th) * 0.9
    pr[..., 0, 1] = np.sin(th)
    pr[..., 1, 0] = -np.sin(th)
    pr[..., 1, 1] = np.cos(th) * 0.9
    pt = np.zeros((B, N, 3), np.float32)
    pt[..., :2] = rng.uniform(-5, 5, (B, N, 2))
    ang = rng.uniform(-0.3, 0.3, B)
    bda = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    bda[:, 0, 0], bda[:, 0, 1] = np.cos(ang), -np.sin(ang)
    bda[:, 1, 0], bda[:, 1, 1] = np.sin(ang), np.cos(ang)
    rep = lambda a: np.concatenate([a[:, 0]] * 2, 1)[:, :N]  # noqa: E731
    return (rep(b["rots"]), rep(b["trans"]), rep(b["intrins"]), pr, pt,
            bda.astype(np.float32))


def test_frustum_to_ego_and_voxel_indices_match_jax():
    """Points: f32 algebra in two frameworks, rtol 1e-5. Voxel ids of
    the same points: the same truncation toward zero, so equal."""
    cams = _aug_cams(0)
    frustum = jfr.make_frustum((1.0, 33.0, 2.0), (64, 176), 16)
    want = np.asarray(jfr.frustum_to_ego(jnp.asarray(frustum),
                                         *[jnp.asarray(c) for c in cams]))
    got = tfr.frustum_to_ego(torch.from_numpy(frustum),
                             *[torch.from_numpy(c) for c in cams]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    lower, step, size = (-51.2, -51.2, -5.0), (6.4, 6.4, 8.0), (16, 16, 1)
    ji, jv = jfr.voxel_indices(jnp.asarray(want), lower, step, size)
    ti, tv = tfr.voxel_indices(torch.from_numpy(want.copy()), lower,
                               step, size)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < tv.numpy().mean() < 1


def test_voxel_indices_truncate_toward_zero():
    coor = torch.tensor([[-0.5, 0.5, 0.0], [-1.5, 0.5, 0.0],
                         [1.99, 2.0, 0.0]])
    idx, valid = tfr.voxel_indices(coor, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                   (3, 3, 1))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(),
                                  [[0, 0, 0], [-1, 0, 0], [1, 2, 0]])
    np.testing.assert_array_equal(valid.numpy(), [True, False, True])


def test_camera_mlp_input_matches_jax():
    cams = _aug_cams(1)
    want = jtf.camera_mlp_input(*[jnp.asarray(c) for c in cams])
    got = ttf.camera_mlp_input(*[torch.from_numpy(c) for c in cams])
    assert got.shape == (2, 3, 27)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------
# modules
# --------------------------------------------------------------------

@pytest.mark.parametrize("depth,hw", [(18, (64, 96)), (50, (32, 48))])
def test_resnet_matches_jax(depth, hw):
    x = _randn(depth, 2, *hw, 3)
    v, want = jax_run(jres.ResNet(depth=depth, out_indices=(0, 2, 3)),
                      [x], train=False)
    model = load_flax_variables(tres.ResNet(depth, (0, 2, 3)),
                                {"params": v["params"],
                                 "batch_stats": v["batch_stats"]}).eval()
    with torch.no_grad():
        got = model(nchw(x))
        stem = model(nchw(x), stem_only=True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        close(nhwc(g), w)
    close(nhwc(stem), want[0])


@pytest.mark.parametrize("sizes", [((5, 7), (3, 4)), ((4, 11), (2, 6)),
                                   ((16, 44), (8, 22))])
def test_custom_fpn_matches_jax(sizes):
    """Odd widths: the top-down nearest upsample uses half-pixel
    centres (jax.image.resize 'nearest' == torch 'nearest-exact')."""
    (h4, w4), (h5, w5) = sizes
    c4, c5 = _randn(1, 2, h4, w4, 24), _randn(2, 2, h5, w5, 40)
    v, want = jax_run(jfpn.CustomFPN(out_channels=16), [[c4, c5]])
    model = load_flax_variables(tfpn.CustomFPN([24, 40], 16), v).eval()
    with torch.no_grad():
        got = model([nchw(c4), nchw(c5)])
    close(nhwc(got), want)


def test_fpn_lss_matches_jax():
    xs, xd = _randn(3, 1, 8, 8, 16), _randn(4, 1, 2, 2, 64)
    v, want = jax_run(jfpn.FPN_LSS(out_channels=32), [xs, xd], train=False)
    model = load_flax_variables(tfpn.FPN_LSS(80, 32), v).eval()
    with torch.no_grad():
        got = model(nchw(xs), nchw(xd))
    assert got.shape == (1, 32, 16, 16)
    close(nhwc(got), want)


def test_resize_bilinear_matches_jax():
    x = _randn(5, 2, 3, 5, 4)
    want = jfpn.resize_bilinear(jnp.asarray(x), (7, 11))
    got = tfpn.resize_bilinear(nchw(x), (7, 11))
    close(nhwc(got), want, rtol=1e-6, atol=1e-6)


def test_custom_resnet_matches_jax():
    x = _randn(6, 1, 16, 16, 32)
    v, want = jax_run(jres.CustomResNet(num_channels=(32, 64, 128)), [x],
                      train=False)
    model = load_flax_variables(tres.CustomResNet(32, (32, 64, 128)),
                                v).eval()
    with torch.no_grad():
        got = model(nchw(x))
    for g, w in zip(got, want):
        close(nhwc(g), w)


@pytest.mark.parametrize("mode", ["cost_volume", "zero_volume",
                                  "no_stereo"])
def test_depthnet_matches_jax(mode):
    """With a softmaxed /4 cost volume, with none (the zero volume of a
    first frame), and without the stereo branch."""
    BN, h, w, C, D = 2, 4, 11, 32, 16
    x = _randn(7, BN, h, w, C)
    mlp = _randn(8, BN, 27)
    cv = None
    if mode == "cost_volume":
        cv = np.asarray(jax.nn.softmax(
            jnp.asarray(_randn(9, BN, 4 * h, 4 * w, D)), -1))
    kw = dict(mid_channels=C, context_channels=8, depth_channels=D + 2,
              stereo=mode != "no_stereo", aspp_mid_channels=8,
              aspp_dropout=0.0)
    v, want = jax_run(jdn.DepthNet(**kw), [x, mlp], cost_volume=cv,
                      train=False)
    model = load_flax_variables(tdn.DepthNet(in_channels=C, **kw), v).eval()
    with torch.no_grad():
        got = model(nchw(x), torch.from_numpy(mlp),
                    None if cv is None else nchw(cv))
    close(nhwc(got), want)


def test_centerhead_matches_jax():
    hcfg = tconfig.tiny_config().head
    x = _randn(10, 1, 16, 16, hcfg.in_channels)
    v, want = jax_run(jch.CenterHead(jconfig.tiny_config().head), [x],
                      train=False)
    model = load_flax_variables(tch.CenterHead(hcfg), v).eval()
    with torch.no_grad():
        got = model(nchw(x))
    assert len(got) == len(want) == len(hcfg.tasks)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            close(g[k].numpy(), w[k])


def test_heatmap_bias_init():
    from ocrfdet_tpu_torch.utils.weights import init_weights
    head = init_weights(tch.CenterHead(tconfig.tiny_config().head), seed=1)
    assert torch.all(head.task0.heatmap_out.bias == -2.19)
    assert torch.all(head.task0.reg_out.bias == 0.0)


def test_decode_all_tasks_matches_jax():
    cfg = tconfig.tiny_config()
    rng = np.random.default_rng(11)
    preds = []
    for task in cfg.head.tasks:
        p = {n: rng.normal(0, 1, (2, 16, 16, c)).astype(np.float32)
             for n, c in cfg.head.common_heads}
        p["heatmap"] = rng.normal(-2, 1.5, (2, 16, 16, len(
            task.class_names))).astype(np.float32)
        preds.append(p)
    want = jcoder.decode_all_tasks(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
        jconfig.tiny_config().head, jconfig.tiny_config().grid)
    got = tcoder.decode_all_tasks(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in preds],
        cfg.head, cfg.grid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels.numpy(), np.asarray(w.labels))
        np.testing.assert_allclose(g.scores.numpy(), np.asarray(w.scores),
                                   rtol=1e-6)
        np.testing.assert_allclose(g.boxes.numpy(), np.asarray(w.boxes),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
        assert g.boxes.shape == (2, cfg.head.max_num, 9)


# --------------------------------------------------------------------
# the weight bridge
# --------------------------------------------------------------------

def test_weight_bridge_layouts():
    """conv HWIO -> OIHW, Dense [in,out] -> [out,in], BN leaves."""
    v = {"params": {"a": {"Conv_0": {"kernel": np.zeros((3, 5, 2, 7))},
                          "Dense_0": {"kernel": np.zeros((4, 6)),
                                      "bias": np.zeros(6)},
                          "BatchNorm_0": {"scale": np.ones(7),
                                          "bias": np.zeros(7)}}},
         "batch_stats": {"a": {"BatchNorm_0": {"mean": np.zeros(7),
                                               "var": np.ones(7)}}}}
    sd = flax_to_state_dict(v)
    assert sd["a.Conv_0.weight"].shape == (7, 2, 3, 5)
    assert sd["a.Dense_0.weight"].shape == (6, 4)
    assert set(sd) == {
        "a.Conv_0.weight", "a.Dense_0.weight", "a.Dense_0.bias",
        "a.BatchNorm_0.weight", "a.BatchNorm_0.bias",
        "a.BatchNorm_0.running_mean", "a.BatchNorm_0.running_var",
        "a.BatchNorm_0.num_batches_tracked"}


def test_weight_bridge_is_strict():
    x = _randn(12, 1, 8, 8, 16)
    v, _ = jax_run(jres.ConvBN(8, 3), [x], train=False)
    load_flax_variables(tres.ConvBN(16, 8, 3), v)
    missing = {"params": {"Conv_0": v["params"]["Conv_0"]},
               "batch_stats": v["batch_stats"]}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flax_variables(tres.ConvBN(16, 8, 3), missing)
    extra = {"params": dict(v["params"], Extra_0={"bias": np.zeros(8)}),
             "batch_stats": v["batch_stats"]}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_flax_variables(tres.ConvBN(16, 8, 3), extra)
