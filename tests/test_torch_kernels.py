"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here carries the marker `cuda` and needs an NVIDIA GPU:
the `dev` fixture skips it when there is none. This file imports neither
JAX nor the JAX package, so it also runs where only PyTorch is installed
(`--noconftest` leaves out tests/conftest.py, which imports JAX, so the
marker is registered on the command line):

    python -m pytest --noconftest -p no:cacheprovider \
        -o "markers=cuda: needs an NVIDIA GPU" -m cuda tests/test_torch_kernels.py

Tolerances: K1 rtol 1e-5 / atol 1e-3 (the kernel sums the channels in
another order; its sample coordinates round exactly like the plain
version's, so no out-of-view flag may flip); K2 rtol 1e-5 / atol 1e-5
(it sums each cell's points in chunks of its sorted order, index_add_ in
its own order; the kernel's own result is the same bits on every run);
K3 rtol 1e-5 / atol 1e-5 of the
output scale (the plain version sums the heights in its own order);
K4's forward bit for bit (the same products and sums, rounded
separately in both, in every specialisation). The backward kernels
walk their points in a fixed order (K2 each pixel's points in
ascending p, K3 each row's points in an order of its own, K4 each
texel's points by base tap, then by point: the same bits on every
run): rtol 1e-5, atol 1e-5 of each gradient's scale, against the plain
versions' autograd; K3's point ordering equals its plain version
exactly, K4's binning holds the plain version's keys in each bin and
its dmap has the bits of `point_sample_backward_walk_plain`, and K2's
two ways of naming a pixel's points (the LSS layout, the points sorted
by pixel) give the same bits on LSS streams. K5 (forward and
backward) against its plain version, which sums in the same 128-wide
chunks but in another order inside a chunk: rtol 1e-4, atol 1e-5 of
each output's scale (the tolerance of tests/test_splat.py for the Pallas
kernel against the XLA compositor); the median depth must agree on every
pixel but where T crosses 0.5 within rounding (at most 1 in 10^4).

Also on the card: train-mode BatchNorm's output and running statistics,
and the fp32 flagship training step check of chip_smoke.py, which must
fail when a fault is put into a backward wrapper (run from the
repository's root, so that `chip_smoke` imports).
"""
import numpy as np
import pytest
import torch

from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.config import tiny_config
from ocrfdet_tpu_torch.geometry.frustum import make_frustum
from ocrfdet_tpu_torch.ops import bev_pool as bp
from ocrfdet_tpu_torch.ops import cost_volume as cvm
from ocrfdet_tpu_torch.ops import ht_pool as htp
from ocrfdet_tpu_torch.ops import point_sample as ps
from ocrfdet_tpu_torch.ops import work
from ocrfdet_tpu_torch.ops.splat import composite as ct

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cost_volume_inputs(dev, C, seed=0):
    """tiny_config geometry of frame 1 (1 m of ego motion), post-ReLU
    stem-like features with exact zeros."""
    cfg = tiny_config(with_ocrf=False)
    batch = entry.make_batch(cfg, seed=seed, device=dev)
    H, W = cfg.data.input_size
    Hc, Wc, N = H // 4, W // 4, cfg.data.num_cams
    g = torch.Generator(device=dev).manual_seed(seed)
    curr = torch.randn((1, N, Hc, Wc, C), generator=g, device=dev).relu_()
    prev = torch.randn((1, N, Hc, Wc, C), generator=g, device=dev).relu_()
    frustum = torch.from_numpy(make_frustum(cfg.grid.depth, (H, W),
                                            4)).to(dev)
    az, bz, a2, b2 = cvm.homography_coeffs(
        frustum, batch["k2s_sensor"][:, 1], batch["intrins"][:, 1],
        batch["post_rots"][:, 1], batch["post_trans"][:, 1], (H, W),
        (Hc, Wc))
    return curr, prev, frustum[:, 0, 0, 2].contiguous(), az, bz, a2, b2


@pytest.mark.parametrize("C", [64, 256])
def test_cost_volume_kernel_matches_plain(dev, C):
    args = _cost_volume_inputs(dev, C) + (5.0,)
    before = cvm.KERNEL.launches
    got = cvm.cost_volume(*args)
    want = cvm.cost_volume_plain(*args)
    torch.cuda.synchronize()
    assert cvm.KERNEL.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


def test_cost_volume_kernel_rejects_bad_inputs(dev):
    curr, prev, depths, az, bz, a2, b2 = _cost_volume_inputs(dev, 64)
    with pytest.raises(TypeError, match="float32"):
        cvm.cost_volume(curr.double(), prev, depths, az, bz, a2, b2, 5.0)
    with pytest.raises(ValueError, match="C 64 or 256"):
        cvm.cost_volume(curr[..., :32], prev[..., :32], depths, az, bz, a2,
                        b2, 5.0)
    with pytest.raises(ValueError, match="az"):
        cvm.cost_volume(curr, prev, depths, az[..., :-1], bz, a2, b2, 5.0)


def _walk_inputs(dev, C, kind, seed=0):
    """K1 inputs with coefficient maps made to stress the row window:
    near planes sweep several pixels a plane from outside the image into
    it ("jumps"); some pixels' planes fall behind the camera ("behind");
    the planes' depths alternate near and far, so walks leave the image
    and come back to rows they held many planes before ("reenter")."""
    rng = np.random.default_rng(seed)
    B, N, H, W, D = 1, 2, 12, 20, 40
    near_far = np.linspace(1.0, 60.0, D)
    depths = near_far.copy()
    if kind == "reenter":
        depths[1::2] = near_far[::-1][1::2]
    az = np.ones((B, N, H, W))
    bz = np.full((B, N), 0.5)
    if kind == "behind":      # den = 2 - 0.05 d < 1e-3 beyond d = 40
        az = np.where(rng.random((B, N, H, W)) < 0.5, -0.05, 1.0)
        bz[:] = 2.0
    a2 = np.stack([rng.uniform(0, W - 1, (B, N, H, W)),
                   rng.uniform(0, H - 1, (B, N, H, W))], -1)
    b2 = rng.uniform(-100.0, 100.0, (B, N, 2))
    curr = np.maximum(rng.standard_normal((B, N, H, W, C)), 0)
    prev = np.maximum(rng.standard_normal((B, N, H, W, C)), 0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    return (t(curr), t(prev).to(torch.bfloat16), t(depths), t(az), t(bz),
            t(a2), t(b2))


@pytest.mark.parametrize("kind", ["jumps", "behind", "reenter"])
@pytest.mark.parametrize("C", [64, 256])
def test_cost_volume_kernel_row_window_walks(dev, C, kind):
    """Walks that jump several pixels a plane, planes behind the camera,
    and walks that leave the image and come back: the kernel reuses a
    row only while its pixel is the same, so it matches the plain
    version and no flag flips; its load-counting build loads as many
    rows as the design's host rule (ops/work.py) says it should."""
    args = _walk_inputs(dev, C, kind) + (5.0,)
    got = cvm.cost_volume(*args)
    want = cvm.cost_volume_plain(*args)
    torch.cuda.synchronize()
    assert int(((got - want).abs() > 2.5).sum()) == 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    assert torch.equal(got, cvm.cost_volume(*args))
    H, W = args[0].shape[2:4]
    taps, model = work.k1_row_loads(*args[2:7], H, W)
    assert 0 < model < taps
    assert cvm.cost_volume_row_loads(*args) == model


def _pool_inputs(dev, seed=0, B=2, P=5000, npix=300, C=80, cells=400):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.random((B, P), dtype=np.float32)).to(dev)
    pix = torch.from_numpy(rng.integers(0, npix, (B, P),
                                        dtype=np.int32)).to(dev)
    cell = torch.from_numpy(rng.integers(0, cells + 1, (B, P),
                                         dtype=np.int32)).to(dev)
    feat = torch.from_numpy(rng.standard_normal(
        (B, npix, C), dtype=np.float32)).to(dev)
    return w, pix, cell, feat, cells


def test_bev_pool_kernel_matches_plain(dev):
    args = _pool_inputs(dev)
    before = bp.KERNEL.launches
    got = bp.bev_pool_points(*args)
    want = bp.bev_pool_points_plain(*args)
    torch.cuda.synchronize()
    assert bp.KERNEL.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _pool_f64(w, pix, cell, feat, cells):
    """K2's function summed in float64: [B, cells, C]."""
    B, P = w.shape
    C = feat.shape[-1]
    rows = torch.gather(feat.double(), 1,
                        pix.long()[..., None].expand(B, P, C))
    out = torch.zeros((B, cells + 1, C), dtype=torch.float64,
                      device=w.device)
    out.scatter_add_(1, cell.long()[..., None].expand(B, P, C),
                     rows * w.double()[..., None])
    return out[:, :cells]


@pytest.mark.parametrize("kind", ["b2", "one_cell_most", "empty_cells",
                                  "all_invalid_sample", "c7", "c200"])
def test_bev_pool_forward_intervals(dev, kind):
    """The interval kernel on cells that span many chunks (one cell with
    most points), many empty cells, a sample whose points are all
    invalid, C = 7 (one channel a lane) and C = 200 (two channel blocks):
    it matches the plain version, its error against a float64 sum is no
    larger than the plain version's, it writes exact zeros for empty
    cells and gives the same bits on a second run.

    The cell with ~4,500 points of unit-scale products is held to the
    float64 sum only: the fp32 sum order alone moves it by ~1e-4
    (1.75e-4 between the kernel and index_add_ on an H100)."""
    kw = {"c7": dict(C=7), "c200": dict(C=200),
          "empty_cells": dict(cells=4000)}.get(kind, {})
    w, pix, cell, feat, cells = _pool_inputs(dev, seed=2, **kw)
    if kind == "one_cell_most":
        gen = torch.Generator(device=dev).manual_seed(3)
        most = torch.rand(cell.shape, generator=gen, device=dev) < 0.9
        cell = torch.where(most, torch.full_like(cell, 7), cell)
    if kind == "all_invalid_sample":
        cell[1] = cells
    got = bp.bev_pool_points(w, pix, cell, feat, cells)
    want = bp.bev_pool_points_plain(w, pix, cell, feat, cells)
    again = bp.bev_pool_points(w, pix, cell, feat, cells)
    exact = _pool_f64(w, pix, cell, feat, cells)
    torch.cuda.synchronize()
    if kind != "one_cell_most":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err = float((got.double() - exact).abs().max())
    plain_err = float((want.double() - exact).abs().max())
    assert err <= 2 * plain_err + 1e-6, (err, plain_err)
    assert torch.equal(got, again)
    hit = torch.zeros((cell.shape[0], cells + 1), dtype=torch.bool,
                      device=dev)
    hit.scatter_(1, cell.long(), True)
    assert bool((got[~hit[:, :cells]] == 0).all())
    if kind == "all_invalid_sample":
        assert bool((got[1] == 0).all())


def _grads(fn, args, diff, cot):
    """Gradients of <fn(*args), cot> with respect to args[i], i in diff."""
    args = [a.detach().clone().requires_grad_(i in diff)
            if torch.is_tensor(a) else a for i, a in enumerate(args)]
    out = fn(*args)
    torch.autograd.backward(out, cot)
    return [args[i].grad for i in diff]


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))


def test_bev_pool_kernel_rejects_bad_inputs_and_backward(dev):
    """Bad inputs raise; the backward (dw, dfeat) launches the backward
    kernel once and matches the plain version's autograd."""
    w, pix, cell, feat, cells = _pool_inputs(dev)
    with pytest.raises(TypeError, match="int32"):
        bp.bev_pool_points(w, pix.long(), cell, feat, cells)
    with pytest.raises(ValueError, match="contiguous"):
        bp.bev_pool_points(w, pix, cell, feat.transpose(1, 2).contiguous()
                           .transpose(1, 2), cells)
    cot = torch.randn((w.shape[0], cells, feat.shape[-1]), device=dev)
    before = bp.BWD_KERNEL.launches
    got = _grads(bp.bev_pool_points, (w, pix, cell, feat, cells), (0, 3),
                 cot)
    torch.cuda.synchronize()
    assert bp.BWD_KERNEL.launches == before + 1
    want = _grads(bp.bev_pool_points_plain, (w, pix, cell, feat, cells),
                  (0, 3), cot)
    assert bp.BWD_KERNEL.launches == before + 1
    _assert_grads_close(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(B=1, P=777, npix=33, C=7,
                                             cells=50)],
                         ids=["c80", "ragged"])
def test_bev_pool_backward_kernel_matches_plain(dev, kw):
    """Random streams (no layout: the points sorted by pixel), C = 80
    and 7; the same bits on two runs."""
    w, pix, cell, feat, cells = _pool_inputs(dev, seed=1, **kw)
    cot = torch.randn((w.shape[0], cells, feat.shape[-1]), device=dev)
    got = _grads(bp.bev_pool_points, (w, pix, cell, feat, cells), (0, 3),
                 cot)
    again = _grads(bp.bev_pool_points, (w, pix, cell, feat, cells), (0, 3),
                   cot)
    want = _grads(bp.bev_pool_points_plain, (w, pix, cell, feat, cells),
                  (0, 3), cot)
    assert all(map(torch.equal, got, again))
    _assert_grads_close(got, want)


def _lss_inputs(dev, seed, B, N=3, D=37, fH=2, fW=5, C=16, bev=(6, 5, 2),
                valid_frac=0.5):
    """`bev_pool_lss`'s arguments from random depth, context and voxel
    indices: (depth, feat, vox_idx, valid, bev_size)."""
    rng = np.random.default_rng(seed)
    shape = (B, N, D, fH, fW)
    depth = torch.from_numpy(rng.random(shape, dtype=np.float32))
    feat = torch.from_numpy(rng.standard_normal((B, N, fH, fW, C),
                                                dtype=np.float32))
    vox = torch.from_numpy(np.stack([rng.integers(0, n, shape)
                                     for n in bev], -1))
    valid = torch.from_numpy(rng.random(shape) < valid_frac)
    return (*(t.to(dev) for t in (depth, feat, vox, valid)), bev)


def _lss_pool_inputs(dev, seed, B, N=3, D=37, fH=2, fW=5, **kw):
    """K2's point streams of `lss_points` from `_lss_inputs`, and their
    layout (N, D, HW)."""
    streams = bp.lss_points(*_lss_inputs(dev, seed, B, N, D, fH, fW, **kw))
    return streams, (N, D, fH * fW)


def _k2_bwd_case(dev, kind):
    """(w, pix, cell, feat, cells), the layout (None: no layout), and the
    points whose pix lies outside [0, npix)."""
    if kind.startswith("lss"):
        kw = {"lss_b1": dict(B=1), "lss_b2": dict(B=2, D=70, fH=3, fW=7,
                                                  C=80),
              "lss_c200": dict(B=2, C=200),
              "lss_none_valid": dict(B=2, valid_frac=0.0)}[kind]
        (w, pix, cell, feat, cells), layout = _lss_pool_inputs(dev, 8, **kw)
        return (w, pix, cell, feat, cells), layout, None
    w, pix, cell, feat, cells = _pool_inputs(dev, seed=9)
    out = None
    if kind == "pix_out_of_range":
        gen = torch.Generator(device=dev).manual_seed(10)
        out = torch.rand(pix.shape, generator=gen, device=dev) < 0.2
        far = torch.tensor([-1, feat.shape[1], feat.shape[1] + 3],
                           dtype=torch.int32, device=dev)
        pix = torch.where(out, far[torch.randint(
            0, 3, pix.shape, generator=gen, device=dev)], pix)
    if kind == "all_invalid":
        cell = torch.full_like(cell, cells)
    if kind == "one_pixel_full":      # every point valid, on pixel 3
        pix = torch.full_like(pix, 3)
        cell = cell % cells
    return (w, pix.contiguous(), cell.contiguous(), feat, cells), None, out


@pytest.mark.parametrize("kind", ["lss_b1", "lss_b2", "lss_c200",
                                  "lss_none_valid", "pix_out_of_range",
                                  "all_invalid", "one_pixel_full"])
def test_bev_pool_backward_cases(dev, kind):
    """K2's backward, twice (the same bits), against the plain version's
    autograd, beside test_bev_pool_backward_kernel_matches_plain's random
    streams: LSS streams at batch 1 and 2 (D not a multiple of the
    32-bin slab, pixels past a block's last), C = 200 (two channel
    blocks) and no point in the grid, walked through the layout and
    through the points sorted by pixel (the same bits); pix outside [0,
    npix) (dw 0, held to the plain version with those points outside the
    grid), every cell invalid, one pixel whose every point is in the
    grid."""
    (w, pix, cell, feat, cells), layout, out = _k2_bwd_case(dev, kind)
    gen = torch.Generator(device=dev).manual_seed(11)
    cot = torch.randn((w.shape[0], cells, feat.shape[-1]), generator=gen,
                      device=dev)
    runs = [dict(layout=layout)] + ([dict()] if layout else [])
    before = bp.BWD_KERNEL.launches
    got = [[bp.bev_pool_points_backward(w, pix, cell, feat, cot, cells,
                                        **kw) for _ in range(2)]
           for kw in runs]
    torch.cuda.synchronize()
    assert bp.BWD_KERNEL.launches == before + 2 * len(runs)
    plain_pix, plain_cell = pix, cell
    if out is not None:
        plain_pix = torch.where(out, torch.zeros_like(pix), pix)
        plain_cell = torch.where(out, torch.full_like(cell, cells), cell)
    want = _grads(bp.bev_pool_points_plain,
                  (w, plain_pix, plain_cell, feat, cells), (0, 3), cot)
    for first, second in got:
        assert all(map(torch.equal, first, second))
        _assert_grads_close(first, want)
    if layout:
        assert all(map(torch.equal, got[0][0], got[1][0]))
    dw, dfeat = got[0][0]
    if out is not None:
        assert not bool(dw[out].any())
    if kind in ("all_invalid", "lss_none_valid"):
        assert not bool(dw.any()) and not bool(dfeat.any())


@pytest.mark.parametrize("B", [1, 2])
def test_lss_pool_backward_walks_the_layout(dev, B):
    """`lss_pool`, K2 on the model's path, backs through the backward
    kernel's LSS layout: no sort by pixel (`cell_intervals` runs only for
    the forward's cells, where `bev_pool_points` on the same streams runs
    it twice), one launch of each kernel, the bits of `bev_pool_points`'
    gradients (the points sorted by pixel) and within rtol 1e-5 of
    `lss_pool_plain`'s autograd."""
    from unittest import mock

    depth, feat, vox, valid, bev = _lss_inputs(dev, 13, B, C=80)
    gen = torch.Generator(device=dev)

    def generic(*args):
        return bp.bev_pool_points(*bp.lss_points(*args))

    def grads(pool):
        d, f = (t.clone().requires_grad_() for t in (depth, feat))
        out = pool(d, f, vox, valid, bev)
        cot = torch.randn(out.shape, device=dev, generator=gen.manual_seed(14))
        return torch.autograd.grad(out, (d, f), cot)
    sorts = {}
    for name, pool in (("lss", bp.lss_pool), ("generic", generic)):
        before = (bp.KERNEL.launches, bp.BWD_KERNEL.launches)
        with mock.patch.object(bp, "cell_intervals",
                               wraps=bp.cell_intervals) as ci:
            sorts[name] = (grads(pool), ci.call_count)
        torch.cuda.synchronize()
        assert (bp.KERNEL.launches, bp.BWD_KERNEL.launches) == (
            before[0] + 1, before[1] + 1)
    assert sorts["lss"][1] == 1 and sorts["generic"][1] == 2
    assert all(map(torch.equal, sorts["lss"][0], sorts["generic"][0]))
    _assert_grads_close(sorts["lss"][0], grads(bp.lss_pool_plain))


def test_tiny_slice_through_the_kernels_matches_plain(dev, monkeypatch):
    """The tiny stereo slice in fp32 on the card: 2 K1 + 2 K2 launches per
    request, and the same outputs as with the plain versions."""
    cfg = tiny_config(with_ocrf=False)
    model = entry.build_detector(cfg, dev, seed=0)
    batch = entry.make_batch(cfg, seed=0, device=dev)
    before = (cvm.KERNEL.launches, bp.KERNEL.launches)
    preds, aux, _, _ = entry.infer(model, batch)
    after = (cvm.KERNEL.launches, bp.KERNEL.launches)
    assert after == (before[0] + 2, before[1] + 2)
    monkeypatch.setattr(cvm, "cost_volume", cvm.cost_volume_plain)
    monkeypatch.setattr(bp, "lss_pool", bp.lss_pool_plain)
    p_preds, p_aux, _, _ = entry.infer(model, batch)
    # the reference run really went through the plain versions
    assert (cvm.KERNEL.launches, bp.KERNEL.launches) == after
    torch.testing.assert_close(preds[0]["heatmap"], p_preds[0]["heatmap"],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux["depth"], p_aux["depth"], rtol=0,
                               atol=1e-5)


def _ht_inputs(dev, seed=0, B=1, N=3, HW=44, D=16, C=80, Zh=13, Nq=300):
    """Softmaxed depth, random context, index streams with ~30% invalid
    points; Nq not a multiple of 32 or 256."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, N, HW, D), dtype=np.float32)
    dep = torch.from_numpy(logits).softmax(-1)
    ctx = torch.from_numpy(rng.standard_normal((B, N, HW, C),
                                               dtype=np.float32))
    pix = torch.from_numpy(rng.integers(0, HW, (B, N, Zh, Nq),
                                        dtype=np.int32))
    di = torch.from_numpy(rng.integers(0, D, (B, N, Zh, Nq), dtype=np.int32))
    wv = torch.from_numpy((rng.random((B, N, Zh, Nq)) > 0.3)
                          .astype(np.float32))
    return [t.to(dev).contiguous() for t in (dep, ctx, pix, di, wv)]


@pytest.mark.parametrize("kw", [dict(), dict(B=2, C=16, Zh=5, Nq=64),
                                dict(C=128, Nq=33)],
                         ids=["c80", "b2c16", "c128"])
def test_ht_pool_kernel_matches_plain(dev, kw):
    """C = 80, 16 and 128; the same bits on two runs."""
    args = _ht_inputs(dev, **kw)
    before = htp.KERNEL.launches
    got = htp.ht_pool_points(*args)
    again = htp.ht_pool_points(*args)
    want = htp.ht_pool_points_plain(*args)
    torch.cuda.synchronize()
    assert htp.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_ht_pool_kernel_rejects_bad_inputs_and_backward(dev):
    dep, ctx, pix, di, wv = _ht_inputs(dev)
    with pytest.raises(TypeError, match="int32"):
        htp.ht_pool_points(dep, ctx, pix.long(), di, wv)
    with pytest.raises(ValueError, match="C 129"):
        htp.ht_pool_points(dep, torch.zeros((*ctx.shape[:3], 129),
                                            device=dev), pix, di, wv)
    with pytest.raises(ValueError, match="wv"):
        htp.ht_pool_points(dep, ctx, pix, di, wv[..., :-1].contiguous())
    before = htp.BWD_KERNEL.launches
    cot = torch.randn((dep.shape[0], pix.shape[3], ctx.shape[-1]),
                      device=dev)
    got = _grads(htp.ht_pool_points, (dep, ctx, pix, di, wv), (0, 1), cot)
    torch.cuda.synchronize()
    assert htp.BWD_KERNEL.launches == before + 1
    want = _grads(htp.ht_pool_points_plain, (dep, ctx, pix, di, wv), (0, 1),
                  cot)
    _assert_grads_close(got, want)


def _ht_fwd_case(dev, kind):
    """(dep, ctx, pix, di, wv) of one K3 forward case."""
    kw = {"nq37": dict(Nq=37), "zh5": dict(B=2, Zh=5, Nq=64),
          "c7": dict(C=7, Nq=100), "tall": dict(N=6, Zh=64, Nq=21),
          "many_heights": dict(N=6, Zh=40, Nq=50)}.get(kind, {})
    dep, ctx, pix, di, wv = _ht_inputs(dev, seed=7, **kw)
    if kind == "all_invalid":
        wv = torch.zeros_like(wv)
    if kind == "all_valid":
        wv = torch.ones_like(wv)
    if kind == "one_pixel":            # pillar 5: every point on pixel 17
        wv[..., 5] = 1.0
        pix[..., 5] = 17
    return dep, ctx, pix.contiguous(), di, wv.contiguous()


@pytest.mark.parametrize("kind", ["nq37", "zh5", "c7", "all_invalid",
                                  "all_valid", "one_pixel", "many_heights",
                                  "tall"])
def test_ht_pool_forward_cases(dev, kind):
    """K3's forward against its plain version and the same bits on two
    runs, beside test_ht_pool_kernel_matches_plain's C = 80, 16 and 128
    (Nq 300, 64 and 33, 16-byte staging): Nq 37 (4-byte staging), Zh 5,
    C = 7 (4 channels 32 apart), every point invalid (exact zeros), every
    point valid, one pillar whose heights all hit one pixel, and 240 and
    384 points a pillar (smaller tiles; the last past 48 KB of shared
    memory)."""
    args = _ht_fwd_case(dev, kind)
    before = htp.KERNEL.launches
    got = htp.ht_pool_points(*args)
    again = htp.ht_pool_points(*args)
    want = htp.ht_pool_points_plain(*args)
    torch.cuda.synchronize()
    assert htp.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    if kind == "all_invalid":
        assert not bool(got.any())


@pytest.mark.parametrize("kw", [dict(), dict(B=2, C=16, Zh=5, Nq=64),
                                dict(C=128, Nq=33)],
                         ids=["c80", "b2c16", "c128"])
def test_ht_pool_backward_kernel_matches_plain(dev, kw):
    """Only bin di of each point gets a depth gradient; Nq % 256 != 0."""
    args = _ht_inputs(dev, seed=1, **kw)
    dep, ctx, pix = args[:3]
    cot = torch.randn((dep.shape[0], pix.shape[3], ctx.shape[-1]),
                      device=dev)
    got = _grads(htp.ht_pool_points, args, (0, 1), cot)
    want = _grads(htp.ht_pool_points_plain, args, (0, 1), cot)
    _assert_grads_close(got, want)


def _ht_bwd_case(dev, kind):
    """(dep, ctx, pix, di, wv) of one K3 backward case."""
    if kind == "b1":
        return _ht_inputs(dev, seed=2, B=1)
    if kind == "b2":
        return _ht_inputs(dev, seed=3, B=2, Zh=5, Nq=700)
    if kind == "c40":                      # C not a multiple of 32
        return _ht_inputs(dev, seed=4, B=2, C=40, Nq=97)
    if kind == "c7":
        return _ht_inputs(dev, seed=5, C=7, D=5)
    dep, ctx, pix, di, wv = _ht_inputs(dev, seed=6, B=2, Nq=150)
    if kind == "empty_rows":               # 4 of 44 pixels hit, one
        pix = (pix % 4) * 11               # camera with no valid point
        wv[1, 2] = 0.0
    if kind == "one_full_row":             # every point valid, one pixel
        wv = torch.ones_like(wv)
        pix = torch.full_like(pix, 17)
    return dep, ctx, pix.contiguous(), di, wv.contiguous()


@pytest.mark.parametrize("kind", ["b1", "b2", "c40", "c7", "empty_rows",
                                  "one_full_row"])
def test_ht_pool_backward_cases(dev, kind):
    """K3's backward (ordering and kernel) against the plain version's
    autograd, the same bits on two runs; the ordering equals its plain
    version (the valid points by row, then depth bin, then point);
    batch 1 and 2, C = 40 and 7, rows with no point, one row holding
    every point."""
    args = _ht_bwd_case(dev, kind)
    dep, ctx, pix, di, wv = args
    HW, D = dep.shape[2:]
    cot = torch.randn((dep.shape[0], pix.shape[3], ctx.shape[-1]),
                      device=dev)
    before = (htp.ORDER_KERNEL.launches, htp.BWD_KERNEL.launches)
    got = htp.ht_pool_points_backward(*args, cot)
    again = htp.ht_pool_points_backward(*args, cot)
    torch.cuda.synchronize()
    assert (htp.ORDER_KERNEL.launches, htp.BWD_KERNEL.launches) == (
        before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = _grads(htp.ht_pool_points_plain, args, (0, 1), cot)
    _assert_grads_close(got, want)
    ends, order = htp.ht_pool_order(pix, di, wv, HW, D)
    pends, porder = htp.ht_pool_order_plain(pix, di, wv, HW, D)
    assert torch.equal(ends, pends)
    assert torch.equal(order[:porder.numel()], porder)
    rows = torch.diff(pends, prepend=pends.new_zeros(1))
    if kind == "empty_rows":
        assert int((rows == 0).sum()) > rows.numel() // 2
        assert not bool(got[1][1, 2].any()) and not bool(got[0][1, 2].any())
    if kind == "one_full_row":
        assert int(rows.max()) == pix[0, 0].numel()


def _ps_inputs(dev, seed=0, BN=3, H=40, W=70, C=1, P=5000):
    """Maps and points over and around the image, with edge points in
    (-1, 0) and (W-1, W) and integer points."""
    rng = np.random.default_rng(seed)
    maps = rng.standard_normal((BN, H, W, C), dtype=np.float32)
    px = rng.uniform(-3, W + 3, (BN, P))
    py = rng.uniform(-3, H + 3, (BN, P))
    k = P // 8
    px[:, :k] = rng.uniform(-1, 0, (BN, k))
    px[:, k:2 * k] = rng.uniform(W - 1, W, (BN, k))
    py[:, 2 * k:3 * k] = rng.uniform(H - 1, H, (BN, k))
    px[:, 3 * k:4 * k] = rng.integers(-1, W + 1, (BN, k))
    px[:, 4 * k] = -1e7
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            .to(dev) for a in (maps, px, py)]


@pytest.mark.parametrize("C", [1, 4])
def test_point_sample_kernel_matches_plain(dev, C):
    args = _ps_inputs(dev, C=C)
    before = ps.KERNEL.launches
    got = ps.point_sample_points(*args)
    want = ps.point_sample_points_plain(*args)
    torch.cuda.synchronize()
    assert ps.KERNEL.launches == before + 1
    assert torch.equal(got, want)


def test_point_sample_kernel_rejects_bad_inputs_and_backward(dev):
    maps, px, py = _ps_inputs(dev)
    with pytest.raises(TypeError, match="float32"):
        ps.point_sample_points(maps.double(), px, py)
    with pytest.raises(ValueError, match="C 5"):
        ps.point_sample_points(maps.expand(-1, -1, -1, 5).contiguous(),
                               px, py)
    with pytest.raises(ValueError, match="contiguous"):
        ps.point_sample_points(maps, px[:, ::2], py[:, ::2])
    before = ps.BWD_KERNEL.launches
    cot = torch.randn((*px.shape, maps.shape[-1]), device=dev)
    got = _grads(ps.point_sample_points, (maps, px, py), (0,), cot)
    torch.cuda.synchronize()
    assert ps.BWD_KERNEL.launches == before + 1
    want = _grads(ps.point_sample_points_plain, (maps, px, py), (0,), cot)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_point_sample_backward_kernel_matches_plain(dev, C):
    """Edge points in (-1, 0) and (W-1, W), integer points, P % 256 != 0."""
    maps, px, py = _ps_inputs(dev, seed=1, C=C, P=4999)
    cot = torch.randn((*px.shape, C), device=dev)
    got = _grads(ps.point_sample_points, (maps, px, py), (0,), cot)
    want = _grads(ps.point_sample_points_plain, (maps, px, py), (0,), cot)
    _assert_grads_close(got, want)


def _k4_bwd_case(dev, kind):
    """(px, py, dout, map shape) of one K4 backward case."""
    C = 3 if kind == "c3" else 4
    maps, px, py = _ps_inputs(dev, seed=3, BN=3, H=40, W=70, C=C, P=4999)
    k = px.shape[1] // 8
    if kind == "edges":          # (-1, 0) on both axes, the last row
        px[:, 5 * k:6 * k] = -torch.rand((3, k), device=dev)
        py[:, 5 * k:6 * k] = -torch.rand((3, k), device=dev)
        py[:, 6 * k:7 * k] = 39 + torch.rand((3, k), device=dev)
    if kind == "one_tile":       # a camera's every point in one tile
        px[1] = 17 + 14 * torch.rand(px.shape[1], device=dev)
        py[1] = 1 + 14 * torch.rand(px.shape[1], device=dev)
    if kind == "hot_pixel":      # 20,000 points on one pixel
        px = torch.cat([px, 20.5 + 0.5 * torch.rand((3, 20000),
                                                     device=dev)], 1)
        py = torch.cat([py, torch.full((3, 20000), 9.25, device=dev)], 1)
    if kind == "empty":
        px, py = px[:, :0].contiguous(), py[:, :0].contiguous()
    g = torch.Generator(device=dev).manual_seed(4)
    dout = torch.randn((*px.shape, C), generator=g, device=dev)
    if kind == "dout_4_bytes_off":
        buf = torch.empty(dout.numel() + 1, device=dev)
        dout = buf[1:].view(dout.shape)
        dout.copy_(torch.randn(dout.shape, generator=g, device=dev))
        assert dout.data_ptr() % 16 == 4
    return px.contiguous(), py.contiguous(), dout, (3, 40, 70, C)


@pytest.mark.parametrize("kind", ["random", "c3", "edges",
                                  "dout_4_bytes_off", "one_tile",
                                  "hot_pixel", "empty"])
def test_point_sample_backward_cases(dev, kind):
    """K4's backward (binning and kernel): the bits of the plain walk in
    the kernel's order, the same bits on two runs, within rtol 1e-5 of
    the plain autograd; the binning holds the plain version's keys in
    each bin. C = 3, edge points, dout 4 bytes past 16-byte alignment
    (the scalar form), a bin past 512 keys (sorted in global memory, then
    walked in chunks), one pixel holding 20,000 points, no point."""
    px, py, dout, shape = _k4_bwd_case(dev, kind)
    before = (ps.ORDER_KERNEL.launches, ps.BWD_KERNEL.launches)
    got = ps.point_sample_points_backward(px, py, dout, shape)
    again = ps.point_sample_points_backward(px, py, dout, shape)
    torch.cuda.synchronize()
    assert (ps.ORDER_KERNEL.launches, ps.BWD_KERNEL.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(got, again)
    assert torch.equal(got, ps.point_sample_backward_walk_plain(
        px, py, dout, shape))
    maps = torch.zeros(shape, device=dev)
    want = _grads(ps.point_sample_points_plain, (maps, px, py), (0,), dout)
    if kind == "empty":
        assert not bool(got.any()) and not bool(want[0].any())
    else:
        _assert_grads_close([got], want)
    spans, placed = ps.point_sample_order(px, py, *shape[1:3])
    ends, order = ps.point_sample_order_plain(px, py, *shape[1:3])
    assert torch.equal(torch.cumsum(spans[1] - spans[0], 0), ends)
    assert torch.equal(ps.binned_keys(spans, placed), order)
    n = spans[1] - spans[0]
    if kind in ("one_tile", "hot_pixel"):
        assert int(n.max()) > 512


def test_point_sample_backward_bits_do_not_depend_on_the_placement(dev):
    """The kernel gives the same bits whatever order the place kernel
    wrote each bin's keys in: every bin shuffled, and reversed."""
    px, py, dout, shape = _k4_bwd_case(dev, "one_tile")
    spans, placed = ps.point_sample_order(px, py, *shape[1:3])
    want = ps.point_sample_backward_ordered(px, py, dout, spans,
                                            placed.clone(), shape)
    g = torch.Generator(device=dev).manual_seed(5)
    for way in ("shuffled", "reversed"):
        other = placed.clone()
        for b in range(spans.shape[1]):
            s, e = int(spans[0, b]), int(spans[1, b])
            idx = (torch.randperm(e - s, generator=g, device=dev)
                   if way == "shuffled" else
                   torch.arange(e - s - 1, -1, -1, device=dev))
            other[s:e] = placed[s:e][idx]
        assert not torch.equal(other, placed)
        assert torch.equal(ps.point_sample_backward_ordered(
            px, py, dout, spans, other, shape), want)


def test_point_sample_backward_every_point_on_one_pixel(dev):
    """All 212,992 points of a flagship camera on one pixel (one bin,
    sorted in global memory, walked in 416 chunks): the same bits on two
    runs, and each texel within the recursive-summation bound n u S of
    the float64 sum (n its points, u = 2^-24, S the sum of the
    magnitudes of its terms), the plain walk being too slow here."""
    P, H, W = 212992, 256, 704
    g = torch.Generator(device=dev).manual_seed(6)
    px = (100.5 + 0.5 * torch.rand((2, P), generator=g, device=dev))
    py = torch.full((2, P), 50.25, device=dev)
    px[1] = torch.rand(P, generator=g, device=dev) * (W + 4) - 2
    py[1] = torch.rand(P, generator=g, device=dev) * (H + 4) - 2
    dout = torch.randn((2, P, 4), generator=g, device=dev)
    shape = (2, H, W, 4)
    got = ps.point_sample_points_backward(px, py, dout, shape)
    again = ps.point_sample_points_backward(px, py, dout, shape)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    m64 = torch.zeros(shape, dtype=torch.float64, device=dev,
                      requires_grad=True)
    ps.point_sample_points_plain(m64, px.double(), py.double()).backward(
        dout.double())
    mabs = torch.zeros_like(m64, requires_grad=True)
    ps.point_sample_points_plain(mabs, px.double(), py.double()).backward(
        dout.double().abs())
    bound = P * 2.0 ** -24 * mabs.grad
    assert bool(((got.double() - m64.grad).abs() <= bound).all())
    assert float(got[0].abs().sum()) > 0 and int((got[0] != 0).sum()) <= 16


def _kernel_names(fn, key):
    """Names of the device kernels containing `key` that fn() launches."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if key in e.name}


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_point_sample_forward_forms_are_bit_identical(dev, C):
    """Every C specialisation of K4's forward gives the plain version's
    bits on points on the image edges, outside it and in (-1, 0) on both
    axes; for C = 4 the 16-byte form (aligned maps) and the scalar form
    (a maps view 4 bytes past 16-byte alignment, which the launcher must
    send to the scalar form) both do."""
    maps, px, py = _ps_inputs(dev, seed=2, C=C, P=4999)
    k = px.shape[1] // 8
    py[:, 5 * k:6 * k] = torch.rand((px.shape[0], k), device=dev) - 1
    px[:, 6 * k:7 * k] = -torch.rand((px.shape[0], k), device=dev)
    py[:, 6 * k:7 * k] = -torch.rand((px.shape[0], k), device=dev)
    want = ps.point_sample_points_plain(maps, px, py)
    assert torch.equal(ps.point_sample_points(maps, px, py), want)
    if C == 4:
        buf = torch.empty(maps.numel() + 1, device=dev)
        shifted = buf[1:].view(maps.shape)
        shifted.copy_(maps)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
        assert torch.equal(ps.point_sample_points(shifted, px, py), want)
        key = "point_sample_forward_kernel"
        vec = _kernel_names(lambda: ps.point_sample_points(maps, px, py), key)
        sca = _kernel_names(lambda: ps.point_sample_points(shifted, px, py),
                            key)
        assert len(vec) == len(sca) == 1 and vec != sca, (vec, sca)
        assert "true" in vec.pop() and "false" in sca.pop()


def _composite_inputs(dev, seed=0, T=12, n_tx=4, M=200):
    """Random depth-sorted Gaussians per 16x16 tile, ~20% dead slots."""
    rng = np.random.default_rng(seed)
    W, H = n_tx * 16, -(-T // n_tx) * 16
    s = rng.uniform(1, 6, (T, M))
    ca = 1 / s ** 2
    cc = 1 / (s * rng.uniform(0.7, 1.3, (T, M))) ** 2
    cb = rng.uniform(-0.3, 0.3, (T, M)) * np.sqrt(ca * cc)
    attrs = np.stack([rng.uniform(-5, W + 5, (T, M)),
                      rng.uniform(-5, H + 5, (T, M)), ca, cb, cc,
                      np.ceil(3 * s * 1.3),
                      np.sort(rng.uniform(1, 30, (T, M)), 1),
                      rng.uniform(0, 1, (T, M)) * (rng.random((T, M)) > 0.2),
                      *rng.random((3, T, M))], -1)
    cots = (rng.standard_normal((T, 256, 3)), rng.standard_normal((T, 256)),
            rng.standard_normal((T, 256)))
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            .to(dev) for a in (attrs, *cots)]


def _assert_composite_close(got, want):
    (rgb, med, logt), (prgb, pmed, plogt) = got, want
    for a, b in ((rgb, prgb), (logt, plogt)):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.detach().abs().max()))
    flips = int((med - pmed).abs().gt(1e-5 * pmed.abs()).sum())
    assert flips <= max(1, med.numel() // 10000), flips


@pytest.mark.parametrize("kw", [dict(), dict(T=13, n_tx=5, M=300),
                                dict(T=8, n_tx=4, M=512)],
                         ids=["m200", "ragged", "m512"])
def test_composite_kernel_matches_plain(dev, kw):
    """K5 forward and backward (one launch each) against the plain
    mirror; T not a multiple of the tiles per row, M not a multiple of
    128 in the first two cases."""
    attrs, g_rgb, g_med, g_logt = _composite_inputs(dev, **kw)
    T, n_tx = attrs.shape[0], kw.get("n_tx", 4)
    before = (ct.KERNEL.launches, ct.BWD_KERNEL.launches)
    a = attrs.clone().requires_grad_()
    got = ct.composite_tiles(a, T, n_tx, 16, 16)
    torch.autograd.backward(got, (g_rgb, g_med, g_logt))
    torch.cuda.synchronize()
    assert (ct.KERNEL.launches, ct.BWD_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    p = attrs.clone().requires_grad_()
    want = ct.composite_tiles_plain(p, T, n_tx, 16, 16)
    torch.autograd.backward(want, (g_rgb, g_med, g_logt))
    assert (ct.KERNEL.launches, ct.BWD_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_composite_close(got, want)
    for i, name in enumerate(ct.STREAMS):
        torch.testing.assert_close(
            a.grad[..., i], p.grad[..., i], rtol=1e-4,
            atol=1e-5 * max(1e-6, float(p.grad[..., i].abs().max())),
            msg=name)


def test_composite_kernel_rejects_bad_inputs(dev):
    attrs = _composite_inputs(dev)[0]
    with pytest.raises(TypeError, match="float32"):
        ct.composite_tiles(attrs.double(), 12, 4, 16, 16)
    with pytest.raises(ValueError, match="256 pixels"):
        ct.composite_tiles(attrs, 12, 4, 8, 16)
    with pytest.raises(ValueError, match="multiple"):
        ct.composite_tiles(attrs, 5, 4, 16, 16)


def _composite_forward_case(dev, kind):
    """(attrs, T, n_tx) of one K5 forward case."""
    if kind == "underflow":
        # tile 0: 300 Gaussians over the whole tile at alpha 0.99, so
        # that T falls far below the smallest fp32 number (log T ~ -1380)
        attrs = _composite_inputs(dev, seed=8, T=4, n_tx=2, M=400)[0]
        big = attrs[0, :300]
        big[:, 0], big[:, 1] = 7.5, 7.5
        big[:, 2], big[:, 3], big[:, 4] = 1e-4, 0.0, 1e-4
        big[:, 5], big[:, 7] = 100.0, 1.0
        return attrs, 4, 2
    # "ragged_dead": M = 333 (not a multiple of 128), ~40% of the slots
    # dead, tile 1's last 100 slots and tile 2's second chunk all dead
    attrs = _composite_inputs(dev, seed=9, T=6, n_tx=3, M=333)[0]
    g = torch.Generator(device=dev).manual_seed(9)
    attrs[..., 7] *= (torch.rand(attrs.shape[:2], generator=g, device=dev)
                      > 0.25).float()
    attrs[1, 233:, 7] = 0.0
    attrs[2, 128:256, 7] = 0.0
    return attrs, 6, 3


@pytest.mark.parametrize("kind", ["underflow", "ragged_dead"])
def test_composite_forward_cases(dev, kind):
    """K5's forward kernel against its plain version: rgb and log T at
    rtol 1e-4 / atol 1e-5 of their scale, the median and the crossing
    slot flipping on at most 1 pixel in 10^4 (at least 1), the same bits
    on two runs; T underflowing in a tile (its log T still the sum of
    the log1p terms), M not a multiple of 128 with dead slots."""
    attrs, T, n_tx = _composite_forward_case(dev, kind)
    before = ct.KERNEL.launches
    got = ct.composite_forward(attrs, T, n_tx, 16)
    again = ct.composite_forward(attrs, T, n_tx, 16)
    want = ct.composite_forward_plain(attrs, T, n_tx, 16, 16)
    torch.cuda.synchronize()
    assert ct.KERNEL.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_composite_close(got[:3], want[:3])
    assert int((got[3] != want[3]).sum()) <= max(1, got[3].numel() // 10000)
    if kind == "underflow":
        logt = want[2][0]
        assert float(logt.max()) < -1000.0
        assert bool(torch.isfinite(got[2]).all())
        assert bool((want[3][0] >= 0).all())


def _composite_case(dev, kind):
    """(attrs, g_rgb, g_med, g_logt, T, n_tx) of one K5 backward case."""
    if kind == "m300":
        return (*_composite_inputs(dev, seed=3, T=13, n_tx=5, M=300), 13, 5)
    if kind == "m20":
        return (*_composite_inputs(dev, seed=4, T=6, n_tx=3, M=20), 6, 3)
    if kind == "dead_chunk":      # tile 3's second chunk is all dead
        attrs, *cots = _composite_inputs(dev, seed=5, T=8, n_tx=4, M=300)
        attrs[3, 128:256, 7] = 0.0
        return (attrs, *cots, 8, 4)
    if kind == "capped":          # opacity 1: alpha capped near the centre
        attrs, *cots = _composite_inputs(dev, seed=6, T=8, n_tx=4, M=256)
        attrs[:, ::3, 7] = 1.0
        return (attrs, *cots, 8, 4)
    # "crossing_at_chunk_start": in every tile, 64 wide flat Gaussians of
    # chunk 0 leave T ~0.6 (the other 64 are dead) and slot 128 (chunk 1's
    # first) takes it to ~0.3, so every pixel's median crosses there
    T, n_tx, M = 4, 2, 256
    attrs, *cots = _composite_inputs(dev, seed=7, T=T, n_tx=n_tx, M=M)
    t = torch.arange(T, device=dev)
    cx = ((t % n_tx) * 16 + 7.5)[:, None]
    cy = ((t // n_tx) * 16 + 7.5)[:, None]
    flat = attrs[:, :129]
    flat[..., 0], flat[..., 1] = cx, cy
    flat[..., 2], flat[..., 3], flat[..., 4] = 1e-4, 0.0, 1e-4
    flat[..., 5] = 100.0
    flat[..., 6] = torch.linspace(0.5, 0.9, 129, device=dev)
    flat[:, :128, 7] = torch.where(torch.arange(128, device=dev) % 2 == 0,
                                   0.0079, 0.0)
    flat[:, 128, 7] = 0.5
    attrs[:, 129:, 6] += 1.0
    return (attrs, *cots, T, n_tx)


@pytest.mark.parametrize("kind", ["m300", "m20", "dead_chunk", "capped",
                                  "crossing_at_chunk_start"])
def test_composite_backward_cases(dev, kind):
    """K5's backward kernel against its plain version per stream, both
    reading the plain forward's crossing slots (M not a multiple of 128,
    M < 32, a tile whose second chunk is all dead, capped alpha, T
    crossing 0.5 at a chunk's first slot; g_logt is never 0) and the same
    bits on two runs. The forward kernel's crossing slots agree with the
    plain forward's."""
    attrs, g_rgb, g_med, g_logt, T, n_tx = _composite_case(dev, kind)
    rgb, _, _, cross = ct.composite_forward_plain(attrs, T, n_tx, 16, 16)
    args = (attrs, rgb, g_rgb, g_logt, g_med, cross, T, n_tx, 16)
    before = ct.BWD_KERNEL.launches
    got = ct.composite_backward(*args)
    again = ct.composite_backward(*args)
    want = ct.composite_backward_plain(*args[:-1], 16, 16)
    torch.cuda.synchronize()
    assert ct.BWD_KERNEL.launches == before + 2
    assert torch.equal(got, again)
    for i, name in enumerate(ct.STREAMS):
        torch.testing.assert_close(
            got[..., i], want[..., i], rtol=1e-4,
            atol=1e-5 * max(1e-6, float(want[..., i].abs().max())),
            msg=name)
    kcross = ct.composite_forward(attrs, T, n_tx, 16)[3]
    assert int((kcross != cross).sum()) <= max(1, cross.numel() // 10000)
    if kind == "crossing_at_chunk_start":
        assert bool((cross == 128).all()) and bool((kcross == 128).all())
        ddep = want[..., 6]
        assert bool((ddep[:, 128] != 0).all())
        assert not bool(ddep[:, :128].any())
    if kind == "capped":
        q = ct._chunk_quantities(attrs[:, :ct.CHUNK], *ct._pixel_coords(
            T, T, n_tx, 16, 16, dev))
        assert bool((q["keep"] & (q["raw"] >= 0.99)).any())


def test_tiny_ocrf_slice_through_the_kernels_matches_plain(dev,
                                                           monkeypatch):
    """The tiny OcRF slice in fp32 on the card: 2 launches of each of
    K1-K4 per request, and the same outputs as with the plain
    versions."""
    cfg = tiny_config(with_ocrf=True)
    model = entry.build_detector(cfg, dev, seed=0)
    batch = entry.make_batch(cfg, seed=0, device=dev)
    ks = (cvm.KERNEL, bp.KERNEL, htp.KERNEL, ps.KERNEL)
    before = [k.launches for k in ks]
    preds, aux, _, dets = entry.infer(model, batch)
    after = [k.launches for k in ks]
    assert after == [b + 2 for b in before]
    monkeypatch.setattr(cvm, "cost_volume", cvm.cost_volume_plain)
    monkeypatch.setattr(bp, "lss_pool", bp.lss_pool_plain)
    monkeypatch.setattr(htp, "ht_pool_points", htp.ht_pool_points_plain)
    monkeypatch.setattr(ps, "point_sample_points",
                        ps.point_sample_points_plain)
    p_preds, p_aux, _, _ = entry.infer(model, batch)
    assert [k.launches for k in ks] == after
    torch.testing.assert_close(preds[0]["heatmap"], p_preds[0]["heatmap"],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux["depth"], p_aux["depth"], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(aux["opacity_bev_logit"],
                               p_aux["opacity_bev_logit"], rtol=1e-4,
                               atol=1e-4)
    assert len(dets) == 1 and dets[0]["boxes"].shape[1] == 9


def test_tiny_training_step_through_the_kernels(dev):
    """One tiny OcRF training step on the card (stereo on): 2 launches
    of K1 and of each forward of K2-K4, 1 of each of their backwards
    (and of K4's binning) and of K5's forward and backward; finite
    losses, the step committed."""
    cfg = tiny_config()
    state = entry.build_trainer(cfg, dev, seed=0)
    batch = entry.make_batch(cfg, seed=0, batch_size=2, device=dev,
                             with_targets=True)
    ks = (cvm.KERNEL, bp.KERNEL, bp.BWD_KERNEL, htp.KERNEL, htp.BWD_KERNEL,
          ps.KERNEL, ps.BWD_KERNEL, ct.KERNEL, ct.BWD_KERNEL,
          ps.ORDER_KERNEL)
    before = [k.launches for k in ks]
    metrics = entry.train_step(state, batch)
    assert [k.launches - b for k, b in zip(ks, before)] == [
        2, 2, 1, 2, 1, 2, 1, 1, 1, 1]
    assert metrics["skipped_nonfinite"] == 0.0 and state.step == 1
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_batchnorm_statistics_on_the_card(dev, dtype, channels_last):
    """Train-mode BatchNorm (models/norm.py, through cuDNN where it
    applies) normalises as F.batch_norm does, bit for bit, and moves its
    running statistics toward the biased batch statistics (flax)."""
    import torch.nn.functional as F
    from ocrfdet_tpu_torch.models.norm import BatchNorm2d
    g = torch.Generator(device=dev).manual_seed(0)
    bn = BatchNorm2d(64, eps=1e-5).to(dev).train()
    x = (3 * torch.randn((6, 64, 32, 44), generator=g, device=dev)
         + 1).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    y = bn(x)
    var, mean = torch.var_mean(x.float(), (0, 2, 3), correction=0)
    torch.testing.assert_close(
        y, F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, 1e-5),
        rtol=0, atol=0)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-5,
                               atol=1e-6)


def _faults():
    def wrap(mod, attr, change):
        f = getattr(mod, attr)
        return mod, attr, lambda *a, **k: change(f(*a, **k))
    return {
        "K3 ddep x0.5": wrap(htp, "ht_pool_points_backward",
                             lambda r: (0.5 * r[0], r[1])),
        "K3 dctx = 0": wrap(htp, "ht_pool_points_backward",
                            lambda r: (r[0], torch.zeros_like(r[1]))),
        "K2 dw = 0": wrap(bp, "bev_pool_points_backward",
                          lambda r: (torch.zeros_like(r[0]), r[1])),
        "K2 dfeat x0.9": wrap(bp, "bev_pool_points_backward",
                              lambda r: (r[0], 0.9 * r[1])),
        "K4 dmap x0.9": wrap(ps, "point_sample_points_backward",
                             lambda r: 0.9 * r),
        "K5 dattrs x0.9": wrap(ct, "composite_backward", lambda r: 0.9 * r)}


@pytest.mark.parametrize("fault", ["K3 ddep x0.5", "K3 dctx = 0",
                                   "K2 dw = 0", "K2 dfeat x0.9",
                                   "K4 dmap x0.9",
                                   "K5 dattrs x0.9"])
def test_fp32_step_check_catches_backward_faults(dev, fault):
    """chip_smoke.py's fp32 flagship step check (K2-K5 against their
    plain versions, to the kernels' run-to-run floor) fails when a
    backward wrapper is wrong: the fault is put into the wrapper at run
    time. Prints what the check reported."""
    from unittest import mock

    import chip_smoke
    ks = [cvm.KERNEL, bp.KERNEL, bp.BWD_KERNEL, htp.KERNEL, htp.BWD_KERNEL,
          ps.KERNEL, ps.BWD_KERNEL, ct.KERNEL, ct.BWD_KERNEL]
    mod, attr, faulty = _faults()[fault]
    with mock.patch.object(mod, attr, faulty), \
            pytest.raises(AssertionError, match="fp32 step") as err:
        chip_smoke.check_fp32_step(dev, ks)
    print(f"{fault}: {err.value}")
