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
(fp32 atomics add in a varying order); K3 rtol 1e-5 / atol 1e-5 of the
output scale (the plain version sums the heights in its own order);
K4 rtol 1e-5 / atol 1e-6 (the same products and sums, rounded
separately in both).
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


def test_bev_pool_kernel_rejects_bad_inputs_and_backward(dev):
    w, pix, cell, feat, cells = _pool_inputs(dev)
    with pytest.raises(TypeError, match="int32"):
        bp.bev_pool_points(w, pix.long(), cell, feat, cells)
    with pytest.raises(ValueError, match="contiguous"):
        bp.bev_pool_points(w, pix, cell, feat.transpose(1, 2).contiguous()
                           .transpose(1, 2), cells)
    out = bp.bev_pool_points(w.requires_grad_(), pix, cell, feat, cells)
    with pytest.raises(NotImplementedError, match="backward"):
        out.sum().backward()


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
    monkeypatch.setattr(bp, "bev_pool_points", bp.bev_pool_points_plain)
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
    args = _ht_inputs(dev, **kw)
    before = htp.KERNEL.launches
    got = htp.ht_pool_points(*args)
    want = htp.ht_pool_points_plain(*args)
    torch.cuda.synchronize()
    assert htp.KERNEL.launches == before + 1
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
    out = htp.ht_pool_points(dep, ctx.requires_grad_(), pix, di, wv)
    with pytest.raises(NotImplementedError, match="backward"):
        out.sum().backward()


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
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_point_sample_kernel_rejects_bad_inputs_and_backward(dev):
    maps, px, py = _ps_inputs(dev)
    with pytest.raises(TypeError, match="float32"):
        ps.point_sample_points(maps.double(), px, py)
    with pytest.raises(ValueError, match="C 5"):
        ps.point_sample_points(maps.expand(-1, -1, -1, 5).contiguous(),
                               px, py)
    with pytest.raises(ValueError, match="contiguous"):
        ps.point_sample_points(maps, px[:, ::2], py[:, ::2])
    out = ps.point_sample_points(maps.requires_grad_(), px, py)
    with pytest.raises(NotImplementedError, match="backward"):
        out.sum().backward()


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
    monkeypatch.setattr(bp, "bev_pool_points", bp.bev_pool_points_plain)
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
