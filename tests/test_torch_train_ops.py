"""The port's training-only ops against the JAX package on the CPU.

* CenterHead targets: identical arrays (numpy in both); the training
  batch of the flagship config equals JAX's key for key (the tiny one is
  in tests/test_torch_modules.py::test_make_batch_matches_jax).
* Every loss function and `ssim`: rtol 1e-5 (fp32, another reduction
  order only).
* `splat_camera` and `preprocess_gaussians`: rtol 1e-5 / atol 1e-5 of
  the scale; the 3-sigma radius (a ceil) and the validity equal.
* The tile selection (`_compact`, `_select_packed`) on identical inputs
  with exact depth ties (camera 0 of the synthetic rig looks along +x,
  so every voxel plane x = const has one camera depth): the packed tile
  streams, and so the selected Gaussians in their order, are identical,
  and so is the overflow count.
* K5's plain version against the JAX `composite_tiles` (the Pallas
  kernel in interpret mode), forward and backward: rtol 1e-4 / atol 1e-5
  of each output's scale, the tolerance of
  tests/test_splat.py::test_tiled_pallas_matches_xla_backend; and the
  port's tiled and dense renderers against JAX's dense one on a small
  scene: the same.
* The plain versions of K2, K3 and K4 differentiated by autograd against
  JAX autodiff of `bev_pool_lss(impl="segsum")`, `ht_pool_ref` and
  `point_sample_ref`: rtol 1e-5, atol 1e-5 of each gradient's scale.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.core import targets as jtargets
from ocrfdet_tpu.data.synthetic import make_batch as jmake_batch
from ocrfdet_tpu.geometry import frustum as jfr
from ocrfdet_tpu.geometry.cameras import splat_camera as jsplat_camera
from ocrfdet_tpu.losses import center as jcenter
from ocrfdet_tpu.losses import depth as jdepth
from ocrfdet_tpu.losses import mask as jmask
from ocrfdet_tpu.losses import render as jrender
from ocrfdet_tpu.ops import bev_pool as jbp
from ocrfdet_tpu.ops import ht_pool as jht
from ocrfdet_tpu.ops import point_sample as jps
from ocrfdet_tpu.ops.splat import preprocess as jpre
from ocrfdet_tpu.ops.splat import render_tiled as jtiled
from ocrfdet_tpu.ops.splat.render_pallas import composite_tiles as jcomposite
from ocrfdet_tpu.ops.splat.render_xla import render_gaussians_dense as jdense
from ocrfdet_tpu.ops.ssim import ssim as jssim
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch.core import targets as ttargets
from ocrfdet_tpu_torch.data.synthetic import make_batch as tmake_batch
from ocrfdet_tpu_torch.geometry.cameras import splat_camera
from ocrfdet_tpu_torch.losses import center, depth, mask, render
from ocrfdet_tpu_torch.ops import bev_pool as tbp
from ocrfdet_tpu_torch.ops import ht_pool as tht
from ocrfdet_tpu_torch.ops import point_sample as tps
from ocrfdet_tpu_torch.ops.splat import composite
from ocrfdet_tpu_torch.ops.splat import preprocess as tpre
from ocrfdet_tpu_torch.ops.splat import render_tiled as ttiled
from ocrfdet_tpu_torch.ops.splat.render_dense import render_gaussians_dense
from ocrfdet_tpu_torch.ops.ssim import ssim

T = torch.from_numpy


def _close(got, want, rtol=1e-5, atol=1e-5, msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())),
        err_msg=msg)


# ------------------------------------------------------------ targets
def test_centerpoint_targets_match_jax():
    cfg = tconfig.tiny_config()
    jcfg = jconfig.tiny_config()
    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.uniform(-50, 50, (20, 2)),
                            rng.uniform(-1, 1, (20, 1)),
                            rng.uniform(0.5, 6, (20, 3)),
                            rng.uniform(-3, 3, (20, 3))], 1).astype(np.float32)
    labels = rng.integers(0, 10, 20)
    mine = ttargets.stack_targets([ttargets.centerpoint_targets(
        boxes, labels, cfg.head, cfg.grid)] * 2)
    ref = jtargets.stack_targets([jtargets.centerpoint_targets(
        boxes, labels, jcfg.head, jcfg.grid)] * 2)
    np.testing.assert_equal(mine, ref)
    assert ttargets.gaussian_radius((3.0, 5.0), 0.1) == \
        jtargets.gaussian_radius((3.0, 5.0), 0.1)


def test_flagship_training_batch_matches_jax():
    mine = tmake_batch(tconfig.ocrfdet_config(), batch_size=1, seed=2,
                       with_targets=True)
    ref = jmake_batch(jconfig.ocrfdet_config(), batch_size=1, seed=2)
    assert set(mine) == set(ref)
    for k, v in mine.items():
        np.testing.assert_equal(v, ref[k], err_msg=k)


# ------------------------------------------------------------- losses
def test_depth_semantic_losses_match_jax():
    rng = np.random.default_rng(1)
    BN, H, W, ds, D = 4, 32, 64, 8, 16
    depth_cfg = (1.0, 33.0, 2.0)
    gt_d = np.where(rng.random((BN, H, W)) < 0.3,
                    rng.uniform(0, 40, (BN, H, W)), 0).astype(np.float32)
    gt_s = (rng.random((BN, H, W)) < 0.4).astype(np.float32)
    labels = depth.build_depth_semantic_labels(T(gt_d), T(gt_s), depth_cfg,
                                               D, ds)
    jlabels = jdepth.build_depth_semantic_labels(
        jnp.asarray(gt_d), jnp.asarray(gt_s), depth_cfg, D, ds)
    for a, b in zip(labels, jlabels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dp = T(rng.random((BN, H // ds, W // ds, D), dtype=np.float32)).softmax(-1)
    sp = T(rng.random((BN, H // ds, W // ds, 2), dtype=np.float32)).softmax(-1)
    got = depth.depth_semantic_loss(dp, sp, *labels, 3.0, 25.0)
    want = jdepth.depth_semantic_loss(jnp.asarray(dp.numpy()),
                                      jnp.asarray(sp.numpy()), *jlabels,
                                      3.0, 25.0)
    for a, b in zip(got, want):
        _close(a, b)


def test_center_mask_render_losses_and_ssim_match_jax():
    cfg = tconfig.tiny_config()
    rng = np.random.default_rng(2)
    b = tmake_batch(cfg, batch_size=2, seed=4, with_targets=True)
    Y, X = cfg.vt.bev_h, cfg.vt.bev_w
    preds = [{k: rng.standard_normal((2, Y, X, c)).astype(np.float32)
              for k, c in (("heatmap", len(t.class_names)), ("reg", 2),
                           ("height", 1), ("dim", 3), ("rot", 2),
                           ("vel", 2))} for t in cfg.head.tasks]
    tgts = {k: b[k] for k in ("heatmaps", "anno_boxes", "inds", "masks")}
    got = center.center_head_loss(
        [{k: T(v) for k, v in p.items()} for p in preds],
        {k: [T(t) for t in v] for k, v in tgts.items()},
        cfg.head.code_weights)
    want = jcenter.center_head_loss(
        jax.tree.map(jnp.asarray, preds), jax.tree.map(jnp.asarray, tgts),
        cfg.head.code_weights)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], msg=k)

    logit = rng.standard_normal((2, Y, X, 1)).astype(np.float32)
    cen = rng.uniform(1, 2, (Y, X)).astype(np.float32)
    for a, w in zip(mask.bev_mask_loss(T(logit), T(b["gt_bev_mask"]),
                                       T(cen)),
                    jmask.bev_mask_loss(jnp.asarray(logit),
                                        jnp.asarray(b["gt_bev_mask"]),
                                        jnp.asarray(cen))):
        _close(a, w)

    H, W = cfg.data.input_size
    imgs = [rng.random((2, H, W, 3), dtype=np.float32) for _ in range(4)]
    deps = [rng.random((2, H, W), dtype=np.float32) for _ in range(3)]
    for use in (0.0, 1.0):
        args = (*imgs, *deps, b["gt_depth"][:, 0], b["render_box_mask"],
                np.float32(use))
        got = render.render_losses(*[T(np.asarray(a)) for a in args])
        want = jrender.render_losses(*[jnp.asarray(a) for a in args])
        for k in want:
            _close(got[k], want[k], msg=k)
    _close(ssim(T(imgs[0]), T(imgs[1])),
           jssim(jnp.asarray(imgs[0]), jnp.asarray(imgs[1])))


# -------------------------------------------------- camera, preprocess
def _tiny_scene(seed=0):
    """The tiny config's voxel Gaussians seen by camera 0 of the rig,
    with random covariances, colours and opacities."""
    cfg = tconfig.tiny_config()
    vt, grid = cfg.vt, cfg.grid
    rng = np.random.default_rng(seed)
    ref = jfr.ht_reference_points(vt.bev_h, vt.bev_w, vt.num_height,
                                  z_pillar=grid.z[1] - grid.z[0])
    pc = np.asarray(grid.pc_range)
    means = (ref * (pc[3:6] - pc[0:3]) + pc[0:3]).reshape(-1, 3) \
        .astype(np.float32)
    G = means.shape[0]
    b = tmake_batch(cfg, batch_size=1, seed=0)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = b["rots"][0, 0, 0]
    c2w[:3, 3] = b["trans"][0, 0, 0]
    return dict(
        cfg=cfg, means=means, c2w=c2w, K=b["intrins"][0, 0, 0],
        quat=rng.standard_normal((G, 4)).astype(np.float32),
        scale=rng.uniform(0.5, 3.0, (G, 3)).astype(np.float32),
        color=rng.random((G, 3), dtype=np.float32),
        opacity=rng.uniform(0.05, 0.95, G).astype(np.float32))


def test_splat_camera_and_preprocess_match_jax():
    s = _tiny_scene()
    H, W = s["cfg"].vt.render_image_size
    cam = splat_camera(T(s["c2w"])[None], T(s["K"])[None], (H, W))
    jcam = jsplat_camera(jnp.asarray(s["c2w"]), jnp.asarray(s["K"]), (H, W))
    for name in ("w2c", "proj", "cam_center", "tan_fovx", "tan_fovy"):
        _close(getattr(cam, name)[0], getattr(jcam, name), msg=name)
    cov = tpre.quat_scale_to_cov3d(T(s["quat"]), T(s["scale"]))
    jcov = jpre.quat_scale_to_cov3d(jnp.asarray(s["quat"]),
                                    jnp.asarray(s["scale"]))
    _close(cov, jcov)
    g = tpre.preprocess_gaussians(T(s["means"]), cov[None], cam)
    jg = jpre.preprocess_gaussians(jnp.asarray(s["means"]), jcov, jcam)
    np.testing.assert_array_equal(g.valid[0].numpy(), np.asarray(jg.valid))
    np.testing.assert_array_equal(g.radius[0].numpy(), np.asarray(jg.radius))
    for name in ("mean2d", "conic", "depth"):
        _close(getattr(g, name)[0], getattr(jg, name), msg=name)


def _jax_gaussians(s):
    H, W = s["cfg"].vt.render_image_size
    jcam = jsplat_camera(jnp.asarray(s["c2w"]), jnp.asarray(s["K"]), (H, W))
    jcov = jpre.quat_scale_to_cov3d(jnp.asarray(s["quat"]),
                                    jnp.asarray(s["scale"]))
    return jpre.preprocess_gaussians(jnp.asarray(s["means"]), jcov, jcam)


def _batched(jg):
    return tpre.Gaussians2D(*[T(np.array(a))[None] for a in jg])


@pytest.mark.parametrize("global_cap", [65536, 700],
                         ids=["select", "compact_then_select"])
def test_tile_selection_matches_jax_exactly(global_cap):
    s = _tiny_scene()
    H, W = s["cfg"].vt.render_image_size
    n_ty, n_tx = H // 16, W // 16
    jg = _jax_gaussians(s)
    depth_np = np.asarray(jg.depth)[np.asarray(jg.valid)]
    assert len(np.unique(depth_np)) < len(depth_np) // 10   # exact ties
    color, opac = jnp.asarray(s["color"]), jnp.asarray(s["opacity"])
    g, tcolor, topac = _batched(jg), T(s["color"])[None], T(
        s["opacity"])[None]
    G = color.shape[0]
    if G > global_cap:
        jg, color, opac = jtiled._compact(jg, color, opac, global_cap)
        g, tcolor, topac = ttiled._compact(g, tcolor, topac, global_cap)
        for a, b in zip(g, jg):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
        G = global_cap
    M = min(512, G)
    select = jax.jit(functools.partial(
        jtiled._select_packed, n_tx=n_tx, n_ty=n_ty, tile_h=16, tile_w=16,
        M=M, coarse_cap=max(2048, M)))
    packed, overflow = select(jg, color, opac)
    attrs, gidx, tover = ttiled._select_packed(
        g, tcolor, topac, n_tx, n_ty, 16, 16, M, coarse_cap=max(2048, M))
    assert attrs.shape == (1, n_ty * n_tx, M, 11)
    for i, k in enumerate(composite.STREAMS):
        np.testing.assert_array_equal(attrs[0, ..., i].numpy(),
                                      np.asarray(packed[k]), err_msg=k)
    assert int(tover[0]) == int(overflow)
    live = attrs[0, ..., 7] > 0
    assert int(live.sum()) > 0 and int(gidx[0][live].max()) < G


# ------------------------------------------------------------------ K5
def _composite_inputs(seed=0, T_=12, n_tx=4, M=200):
    rng = np.random.default_rng(seed)
    W, H = n_tx * 16, -(-T_ // n_tx) * 16
    s = rng.uniform(1, 6, (T_, M))
    ca = 1 / s ** 2
    cc = 1 / (s * rng.uniform(0.7, 1.3, (T_, M))) ** 2
    cb = rng.uniform(-0.3, 0.3, (T_, M)) * np.sqrt(ca * cc)
    attrs = np.stack([rng.uniform(-5, W + 5, (T_, M)),
                      rng.uniform(-5, H + 5, (T_, M)), ca, cb, cc,
                      np.ceil(3 * s * 1.3),
                      np.sort(rng.uniform(1, 30, (T_, M)), 1),
                      rng.uniform(0, 1, (T_, M)) * (rng.random((T_, M)) > 0.2),
                      *rng.random((3, T_, M))], -1).astype(np.float32)
    cots = (rng.standard_normal((T_, 256, 3)).astype(np.float32),
            rng.standard_normal((T_, 256)).astype(np.float32),
            rng.standard_normal((T_, 256)).astype(np.float32))
    return attrs, cots


@pytest.mark.parametrize("M", [200, 300])
def test_plain_composite_matches_jax_pallas(M):
    """Forward and backward, M not a multiple of 128."""
    attrs, (g_rgb, g_med, g_logt) = _composite_inputs(M=M)
    T_, n_tx = attrs.shape[0], 4

    def jfn(packed):
        rgb, med, logt = jcomposite(packed, T_, n_tx, 16, 16)
        return (jnp.sum(rgb * g_rgb) + jnp.sum(med * g_med)
                + jnp.sum(logt * g_logt)), (rgb, med, logt)
    packed = {k: jnp.asarray(attrs[..., i])
              for i, k in enumerate(composite.STREAMS)}
    (_, jout), jgrad = jax.value_and_grad(jfn, has_aux=True)(packed)
    a = T(attrs).requires_grad_()
    out = composite.composite_tiles(a, T_, n_tx, 16, 16)
    torch.autograd.backward(out, (T(g_rgb), T(g_med), T(g_logt)))
    for got, want in zip(out, jout):
        _close(got, want, rtol=1e-4)
    for i, k in enumerate(composite.STREAMS):
        _close(a.grad[..., i], jgrad[k], rtol=1e-4, msg=k)


@pytest.mark.parametrize("M", [200, 300])
def test_plain_composite_crossing_slot_matches_walk(M):
    """The plain forward's crossing slot (which the backward reads)
    against a per-pixel walk in float64 over the plain version's alphas:
    the first kept Gaussian after which T < 0.5, -1 if none; the median
    is that Gaussian's depth (the slots are depth-sorted), 15 if none."""
    attrs, _ = _composite_inputs(seed=1, M=M)
    attrs[0, 20:, 7] = 0.0     # tile 0: 20 Gaussians, pixels that never cross
    T_, n_tx = attrs.shape[0], 4
    a = T(attrs)
    _, med, _, cross = composite.composite_forward_plain(a, T_, n_tx, 16,
                                                         16)
    px, py = composite._pixel_coords(T_, T_, n_tx, 16, 16, a.device)
    alpha = torch.cat([composite._chunk_quantities(
        a[:, k0:k0 + composite.CHUNK], px, py)["alpha"]
        for k0 in range(0, M, composite.CHUNK)], 1).double().numpy()
    t_after = np.cumprod(1.0 - alpha, axis=1)               # [T, M, P]
    crossed = (t_after < 0.5) & (alpha > 0)
    want = np.where(crossed.any(1), crossed.argmax(1), -1)  # [T, P]
    assert cross.dtype == torch.int32
    np.testing.assert_array_equal(cross.numpy(), want)
    has = want >= 0
    assert 0 < has.sum() < has.size
    dep = np.take_along_axis(attrs[..., 6], np.maximum(want, 0), 1)
    np.testing.assert_array_equal(med.numpy()[has], dep[has])
    assert (med.numpy()[~has] == composite.MEDIAN_DEPTH_DEFAULT).all()


def _small_scene(n=60, seed=3):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-3, 3, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(4, 12, n)], -1).astype(np.float32)
    K = np.array([[50.0, 0, 32], [0, 50.0, 16], [0, 0, 1]], np.float32)
    return (means, rng.standard_normal((n, 4)).astype(np.float32),
            rng.uniform(0.1, 0.6, (n, 3)).astype(np.float32),
            rng.random((n, 3), dtype=np.float32),
            rng.uniform(0.2, 0.95, n).astype(np.float32), K)


def test_renderers_match_jax_dense():
    means, quat, scale, color, opac, K = _small_scene()
    H, W = 32, 64
    jcam = jsplat_camera(jnp.eye(4), jnp.asarray(K), (H, W))
    jg = jpre.preprocess_gaussians(
        jnp.asarray(means),
        jpre.quat_scale_to_cov3d(jnp.asarray(quat), jnp.asarray(scale)),
        jcam)
    jimg, jmed = jdense(jg, jnp.asarray(color), jnp.asarray(opac), H, W)
    g = _batched(jg)
    img, med, overflow = ttiled.render_gaussians_tiled(
        g, T(color)[None], T(opac)[None], H, W)
    assert int(overflow[0]) == 0
    _close(img[0], jimg, rtol=1e-4)
    _close(med[0], jmed, rtol=1e-4)
    dimg, dmed = render_gaussians_dense(
        tpre.Gaussians2D(*[t[0] for t in g]), T(color), T(opac), H, W)
    _close(dimg, jimg, rtol=1e-4)
    _close(dmed, jmed, rtol=1e-4)


# ----------------------------------------------- K2, K3, K4 gradients
def _grads_close(got, want):
    for a, b in zip(got, want):
        _close(a, b)


def test_bev_pool_plain_gradients_match_jax():
    rng = np.random.default_rng(5)
    B, N, D, fH, fW, C, X, Y = 2, 2, 6, 4, 11, 16, 16, 16
    depth_ = rng.random((B, N, D, fH, fW), dtype=np.float32)
    feat = rng.standard_normal((B, N, fH, fW, C)).astype(np.float32)
    vox = np.stack([rng.integers(-1, X + 1, (B, N, D, fH, fW)),
                    rng.integers(-1, Y + 1, (B, N, D, fH, fW)),
                    np.zeros((B, N, D, fH, fW), np.int64)], -1)
    valid = (vox[..., 0] >= 0) & (vox[..., 0] < X) & (vox[..., 1] >= 0) \
        & (vox[..., 1] < Y)
    vox = np.clip(vox, 0, [X - 1, Y - 1, 0]).astype(np.int32)
    cot = rng.standard_normal((B, Y, X, C)).astype(np.float32)
    jg = jax.grad(lambda d, f: jnp.sum(jbp.bev_pool_lss(
        d, f, jnp.asarray(vox), jnp.asarray(valid), (X, Y, 1),
        impl="segsum") * cot), argnums=(0, 1))(jnp.asarray(depth_),
                                               jnp.asarray(feat))
    d, f = T(depth_).requires_grad_(), T(feat).requires_grad_()
    (tbp.bev_pool_lss(d, f, T(vox), T(valid), (X, Y, 1)) * T(cot)).sum() \
        .backward()
    _grads_close((d.grad, f.grad), jg)


def test_ht_pool_plain_gradients_match_jax():
    rng = np.random.default_rng(6)
    B, N, h, w, D, C, Zh, Nq = 1, 2, 4, 11, 16, 16, 5, 260
    dep = rng.random((B, N, h, w, D), dtype=np.float32)
    ctx = rng.standard_normal((B, N, h, w, C)).astype(np.float32)
    uvd = rng.uniform(-0.1, 1.1, (B, N, Zh, Nq, 3)).astype(np.float32)
    valid = rng.random((B, N, Zh, Nq)) > 0.3
    cot = rng.standard_normal((B, Nq, C)).astype(np.float32)
    jg = jax.grad(lambda a, b: jnp.sum(jht.ht_pool_ref(
        a, b, jnp.asarray(uvd), jnp.asarray(valid)) * cot),
        argnums=(0, 1))(jnp.asarray(dep), jnp.asarray(ctx))
    a, b = T(dep).requires_grad_(), T(ctx).requires_grad_()
    (tht.ht_pool(a, b, T(uvd), T(valid)) * T(cot)).sum().backward()
    _grads_close((a.grad, b.grad), jg)


def test_point_sample_plain_gradients_match_jax():
    rng = np.random.default_rng(7)
    B, N, H, W, C, P = 1, 2, 20, 30, 4, 777
    maps = rng.standard_normal((B, N, H, W, C)).astype(np.float32)
    px = rng.uniform(-2, W + 1, (B, N, P)).astype(np.float32)
    py = rng.uniform(-2, H + 1, (B, N, P)).astype(np.float32)
    px[..., :50] = rng.uniform(-1, 0, (B, N, 50))
    cot = rng.standard_normal((B, N, P, C)).astype(np.float32)
    jg = jax.grad(lambda m: jnp.sum(jps.point_sample_ref(
        m, jnp.asarray(px), jnp.asarray(py)) * cot))(jnp.asarray(maps))
    m = T(maps).requires_grad_()
    (tps.point_sample(m, T(px), T(py)) * T(cot)).sum().backward()
    _close(m.grad, jg)


# ------------------------------------------- train-mode module semantics
def test_batchnorm_running_statistics_match_flax():
    """Train-mode BatchNorm moves running_var toward the biased batch
    variance, as flax's (momentum 0.9 = torch's 0.1); torch's own
    BatchNorm would use the unbiased one. With one value per channel it
    normalises with a zero variance, as flax does."""
    import flax.linen as fnn
    from ocrfdet_tpu_torch.models.norm import BatchNorm1d, BatchNorm2d
    rng = np.random.default_rng(8)
    for shape, cls in (((3, 5, 4, 6), BatchNorm2d), ((4, 27), BatchNorm1d),
                       ((1, 8, 1, 1), BatchNorm2d)):
        x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
        xl = np.moveaxis(x, 1, -1)
        fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5)
        v = fbn.init(jax.random.PRNGKey(0), jnp.asarray(xl))
        y, mut = fbn.apply(v, jnp.asarray(xl), mutable=["batch_stats"])
        bn = cls(shape[1], eps=1e-5).train()
        with torch.no_grad():
            out = bn(T(x))
        _close(out, np.moveaxis(np.asarray(y), -1, 1), rtol=1e-4)
        _close(bn.running_mean, mut["batch_stats"]["mean"])
        _close(bn.running_var, mut["batch_stats"]["var"])


def test_remat_gives_the_same_step_and_moves_statistics_once():
    """The checkpointed image backbone (backbone.remat, the flagship's
    setting) gives the same gradients and the same BatchNorm statistics
    as without: its recomputation in the backward moves no statistic."""
    import dataclasses
    from ocrfdet_tpu_torch.models.detector import OcRFDet
    from ocrfdet_tpu_torch.train.trainstep import compute_losses, total_loss
    from ocrfdet_tpu_torch.utils.weights import init_weights
    out = []
    for remat in (False, True):
        c = tconfig.tiny_config()
        cfg = dataclasses.replace(c, backbone=dataclasses.replace(
            c.backbone, remat=remat))
        model = init_weights(OcRFDet(cfg, render_heads=True), 0).train()
        batch = {k: [T(t) for t in v] if isinstance(v, list) else T(v)
                 for k, v in tmake_batch(cfg, batch_size=2, seed=0,
                                         with_targets=True).items()}
        preds, aux = model(batch)
        total_loss(compute_losses(cfg, preds, aux, batch)).backward()
        out.append(({n: p.grad for n, p in model.named_parameters()},
                    model.state_dict()))
    (g0, s0), (g1, s1) = out
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0, msg=n)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=0, atol=0, msg=k)
    assert int(s1["img_backbone.stem.BatchNorm_0.num_batches_tracked"]) == 3


def test_aspp_dropout_draws_from_the_generator():
    from ocrfdet_tpu_torch.models.depthnet import ASPP
    torch.manual_seed(0)
    aspp = ASPP(8, 4, 8, dropout=0.5).train()
    x = torch.randn(2, 8, 6, 10)
    outs = []
    for seed in (1, 1, 2):
        aspp.generator = torch.Generator().manual_seed(seed)
        outs.append(aspp(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[2])
    aspp.dropout = 0.0                     # the same train-mode output
    kept = aspp(x)
    live = kept != 0
    dropped = float(((outs[0] == 0) & live).sum() / live.sum())
    assert 0.4 < dropped < 0.6
    torch.testing.assert_close(outs[0][outs[0] != 0],
                               2 * kept[outs[0] != 0])


def test_optimizer_groups_and_schedules_match_jax():
    """The render-lr group is JAX's `is_render_param` on the same paths,
    the frozen group is empty for OcRFDet, and the learning rate, the
    render multiplier and the EMA decay equal JAX's schedules."""
    from ocrfdet_tpu.train import optim as joptim
    from ocrfdet_tpu_torch.models.detector import OcRFDet
    from ocrfdet_tpu_torch.train import optim as toptim
    model = OcRFDet(tconfig.tiny_config(), render_heads=True)
    groups = toptim.param_groups(model.named_parameters())
    assert groups["frozen"] == []
    render = {n for n, _ in groups["render"]}
    for n, _ in model.named_parameters():
        path = [jax.tree_util.DictKey(k) for k in n.split(".")]
        assert joptim.is_render_param(path) == (n in render), n
    assert {n.split(".")[1] for n in render} == {
        "S_MLP", "R_MLP", "A_MLP", "C_MLP", "C_MLP_nerf", "D_MLP_nerf",
        "sigma", "img_feat_resize1", "img_feat_resize2"}
    cfg = tconfig.ocrfdet_config().optim
    jcfg = jconfig.ocrfdet_config().optim
    lr, mult = joptim.lr_schedule(jcfg, 50), joptim.render_mult_schedule(
        jcfg, 50)
    for step in (0, 1, 7, 399, 400, 1000):
        assert toptim.lr_at(cfg, step) == float(lr(jnp.int32(step)))
        assert toptim.render_mult_at(cfg, step, 50) == float(
            mult(jnp.int32(step)))
        assert toptim.ema_decay(cfg, step) == float(
            joptim.ema_decay(jcfg, jnp.int32(step)))


def test_optimizer_and_ema_updates_match_optax():
    """Six updates of train/optim.py's Optimizer (global-norm clip, AdamW
    per group) and EMA against the JAX package's `make_optimizer` (optax)
    and `ema_update`, on a tree with render and other parameters, from
    the same parameters and gradients: through the warm-up (3 steps) and
    two render-lr decays (2 steps per epoch), with gradient norms above
    and below the clip. lr 1e-2 (warm-up from 1e-3), so an update is
    1e-3 to 1e-2 of a parameter,
    and the EMA decay about 0.3 (ema_init_updates 700), so that a wrong
    rate, group, sign, clip or decay moves the result far beyond rtol
    1e-6 (about 8 fp32 roundings) plus 1e-8 (1e-6 of the rate, for
    entries that an update brought near zero)."""
    import dataclasses
    import optax
    from ocrfdet_tpu.train import optim as joptim
    from ocrfdet_tpu_torch.train import optim as toptim
    over = dict(lr=1e-2, warmup_iters=3, warmup_ratio=0.1,
                ema_init_updates=700)
    jcfg = dataclasses.replace(jconfig.ocrfdet_config().optim, **over)
    cfg = dataclasses.replace(tconfig.ocrfdet_config().optim, **over)
    shapes = {"img_backbone.conv.kernel": (3, 3, 4, 6),
              "img_backbone.conv.bias": (6,),
              "img_view_transformer.S_MLP.Dense_0.kernel": (8, 5),
              "img_view_transformer.sigma.kernel": (4, 1),
              "img_view_transformer.height_w": (13,)}
    rng = np.random.default_rng(11)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}

    def tree(flat):
        out = {}
        for k, v in flat.items():
            *path, leaf = k.split(".")
            d = out
            for part in path:
                d = d.setdefault(part, {})
            d[leaf] = jnp.asarray(v)
        return out

    def unflat(t):
        return {k: np.asarray(functools.reduce(lambda d, p: d[p],
                                               k.split("."), t))
                for k in shapes}
    jp = tree(p0)
    tx = joptim.make_optimizer(jcfg, jp, steps_per_epoch=2)
    jstate, jema = tx.init(jp), joptim.ema_init_tree(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    opt = toptim.Optimizer(cfg, list(tp.items()), steps_per_epoch=2)
    assert set(opt.names["render"]) == {
        "img_view_transformer.S_MLP.Dense_0.kernel",
        "img_view_transformer.sigma.kernel"}
    ema = toptim.EMA(tp)
    order = opt.names["render"] + opt.names["other"]
    for step, scale in enumerate((20.0, 0.01, 1.0, 50.0, 0.3, 5.0)):
        g = {k: (scale * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
        updates, jstate = tx.update(tree(g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        jema = joptim.ema_update(jcfg, jema, jp, jnp.int32(step))
        opt.update([torch.tensor(g[k]) for k in order], step)
        ema.update(toptim.ema_decay(cfg, step))
        want_p, want_e = unflat(jp), unflat(jema)
        for k in shapes:
            _close(tp[k], want_p[k], rtol=1e-6, atol=1e-8,
                   msg=f"step {step} {k}")
            _close(ema.as_dict()[k], want_e[k], rtol=1e-6, atol=1e-8,
                   msg=f"step {step} ema {k}")
        moved = max(float(np.abs(want_p[k] - p0[k]).max()) for k in shapes)
        assert moved > 5e-4 * (step + 1)
