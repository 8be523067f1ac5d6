"""The port's ops (kernels K1 and K2, plain versions) against the JAX
package on the CPU.

K1, the stereo cost volume: the port's plain version is held against an
f64 numpy brute force (tight), the JAX Pallas kernel `cost_volume_mm` in
interpret mode at full window, and the JAX gather path
`cost_volume_scan` (both at the repo's bf16 tolerance). K2, the BEV
pool: the port's plain `bev_pool_lss` against JAX `segsum` and `pallas`
(interpret) and the golden case of tests/test_bev_pool.py. The CUDA
kernels themselves are held against these plain versions on the card
(tests/test_torch_kernels.py and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu.ops import bev_pool as jbp
from ocrfdet_tpu.ops import cost_volume as jcv
from ocrfdet_tpu_torch.ops import bev_pool as tbp
from ocrfdet_tpu_torch.ops import cost_volume as tcv

BIAS = 5.0


def _geometry(rng, B, N, Hc, Wc, D, t_scale=0.4, rot=0.1,
              depth_range=(1.5, 20.0)):
    """tests/test_cost_volume_mm.py::_geometry: random key->sweep
    motion, rotated/scaled image augmentation; yields behind-camera,
    out-of-view and border candidates."""
    Hi, Wi = Hc * 4, Wc * 4
    u, v = np.meshgrid(np.linspace(0, Wi - 1, Wc),
                       np.linspace(0, Hi - 1, Hc), indexing="xy")
    depths = np.exp(np.linspace(np.log(depth_range[0]),
                                np.log(depth_range[1]), D))
    frustum = np.stack([
        np.broadcast_to(u, (D, Hc, Wc)),
        np.broadcast_to(v, (D, Hc, Wc)),
        np.broadcast_to(depths[:, None, None], (D, Hc, Wc))],
        -1).astype(np.float32)
    intr = np.broadcast_to(np.array(
        [[60.0, 0, Wi / 2], [0, 60.0, Hi / 2], [0, 0, 1]],
        np.float32), (B, N, 3, 3)).copy()
    k2s = np.broadcast_to(np.eye(4, dtype=np.float32), (B, N, 4, 4)).copy()
    th = rng.uniform(-rot, rot, (B, N))
    k2s[..., 0, 0] = np.cos(th)
    k2s[..., 0, 1] = -np.sin(th)
    k2s[..., 1, 0] = np.sin(th)
    k2s[..., 1, 1] = np.cos(th)
    k2s[..., :3, 3] = rng.standard_normal((B, N, 3)) * t_scale
    thp = rng.uniform(-0.1, 0.1, (B, N))
    pr = np.zeros((B, N, 3, 3), np.float32)
    pr[..., 0, 0] = np.cos(thp) * 0.9
    pr[..., 0, 1] = -np.sin(thp)
    pr[..., 1, 0] = np.sin(thp)
    pr[..., 1, 1] = np.cos(thp) * 0.9
    pr[..., 2, 2] = 1.0
    pt = np.zeros((B, N, 3), np.float32)
    pt[..., :2] = rng.uniform(-3, 3, (B, N, 2))
    return frustum, k2s, intr, pr, pt, (Hi, Wi)


def _case(seed, B=1, N=2, Hc=8, Wc=24, C=16, D=6, **geo):
    """Inputs for both packages: curr signed, prev post-ReLU (exact
    zeros, as the stem's), the port's coefficient maps."""
    rng = np.random.default_rng(seed)
    curr = rng.standard_normal((B, N, Hc, Wc, C)).astype(np.float32)
    prev = np.maximum(rng.standard_normal((B, N, Hc, Wc, C)),
                      0).astype(np.float32)
    frustum, k2s, intr, pr, pt, input_size = _geometry(
        rng, B, N, Hc, Wc, D, **geo)
    az, bz, a2, b2 = tcv.homography_coeffs(
        torch.from_numpy(frustum), torch.from_numpy(k2s),
        torch.from_numpy(intr), torch.from_numpy(pr), torch.from_numpy(pt),
        input_size, (Hc, Wc))
    return dict(curr=curr, prev=prev, depths=frustum[:, 0, 0, 2],
                coef=[t.numpy() for t in (az, bz, a2, b2)],
                geo=(frustum, k2s, intr, pr, pt, input_size))


def _port_cost(c):
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    return tcv.cost_volume(t(c["curr"]), t(c["prev"]), t(c["depths"]),
                           *[t(a) for a in c["coef"]], BIAS).numpy()


def _brute_cost_f64(c):
    """f64 numpy brute force of the exact warp on bf16-rounded prev;
    also returns (#behind candidates, #candidates with only some taps
    in the image)."""
    curr = c["curr"].astype(np.float64)
    prev = torch.from_numpy(c["prev"]).to(torch.bfloat16).double().numpy()
    B, N, H, W, C = curr.shape
    az, bz, a2, b2 = [np.asarray(a, np.float64) for a in c["coef"]]
    inv = tcv._invalid_channel(C)
    D = len(c["depths"])
    out = np.zeros((B, N, D, H, W))
    n_behind = n_border = 0
    for b in range(B):
        for n in range(N):
            img = prev[b, n]
            for di, d in enumerate(np.asarray(c["depths"], np.float64)):
                den = d * az[b, n] + bz[b, n]
                front = den >= 1e-3
                safe = np.where(front, den, 1.0)
                px = (d * a2[b, n, ..., 0] + b2[b, n, 0]) / safe
                py = (d * a2[b, n, ..., 1] + b2[b, n, 1]) / safe
                x0, y0 = np.floor(px), np.floor(py)
                warp = np.zeros((H, W, C))
                n_in = np.zeros((H, W), int)
                for dy in (0, 1):
                    for dx in (0, 1):
                        xi, yi = x0 + dx, y0 + dy
                        wt = ((1 - np.abs(px - xi)) * (1 - np.abs(py - yi)))
                        inb = (front & (xi >= 0) & (xi <= W - 1)
                               & (yi >= 0) & (yi <= H - 1))
                        n_in += inb
                        v = img[np.clip(yi, 0, H - 1).astype(int),
                                np.clip(xi, 0, W - 1).astype(int)]
                        warp += np.where(inb, wt, 0.0)[..., None] * v
                cost = np.abs(curr[b, n] - warp).sum(-1)
                out[b, n, di] = np.where(warp[..., inv] == 0, cost + BIAS,
                                         cost)
                n_behind += int((~front).sum())
                n_border += int(((n_in > 0) & (n_in < 4)).sum())
    return out, n_behind, n_border


GEOMETRIES = {
    "wide_motion": dict(seed=0, t_scale=1.5, rot=0.3),
    "ragged": dict(seed=4, Hc=10, Wc=21, t_scale=0.3),
    "near_planes": dict(seed=2, Wc=32, t_scale=3.0, rot=0.4,
                        depth_range=(1.2, 6.0)),
    "c64": dict(seed=7, C=64, D=5, t_scale=1.0),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_cost_volume_plain_matches_f64_brute_force(name):
    """Same arithmetic, f32 vs f64: a px error of ~1e-5 pixel moves a
    cost of ~C terms by ~1e-4; atol 2e-3 + rtol 1e-5 covers it, far
    below the bias (5.0) that one flipped flag would add."""
    geo = dict(GEOMETRIES[name])
    c = _case(**geo)
    got = _port_cost(c)
    want, n_behind, n_border = _brute_cost_f64(c)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-3)
    # every geometry has border taps; near_planes also has candidates
    # behind the sweep camera
    assert n_border > 0
    assert (n_behind > 0) == (name == "near_planes"), n_behind


@pytest.mark.parametrize("name", ["wide_motion", "near_planes"])
def test_cost_volume_plain_matches_jax_mm_full_window(name):
    """JAX Pallas kernel K1 in interpret mode with a window as large as
    the image (exact warp). It casts the tent weights to bf16 for the
    MXU, so: the repo's bf16 tolerance (tests/test_cost_volume_mm.py)."""
    c = _case(**GEOMETRIES[name])
    az, bz, a2, b2 = [jnp.asarray(a) for a in c["coef"]]
    mm = np.asarray(jcv.cost_volume_mm(
        jnp.asarray(c["curr"]), jnp.asarray(c["prev"]), c["depths"], az, bz,
        a2, b2, BIAS, win_w=64, win_h=64, interpret=True))
    np.testing.assert_allclose(_port_cost(c), mm, rtol=3e-2, atol=3e-1)


@pytest.mark.parametrize("name", ["wide_motion", "ragged"])
def test_cost_volume_plain_matches_jax_scan(name):
    """JAX gather path (the CPU path of cv_impl='auto'), which weights
    and sums the taps in bf16: rtol 3e-2 / atol 3e-1 as the repo's
    tests/test_cost_volume_mm.py states."""
    c = _case(**GEOMETRIES[name])
    az, bz, a2, b2 = [jnp.asarray(a) for a in c["coef"]]
    scan = np.asarray(jcv.cost_volume_scan(
        jnp.asarray(c["curr"]), jnp.asarray(c["prev"]),
        jnp.asarray(c["depths"]), az, bz, a2, b2, BIAS))
    np.testing.assert_allclose(_port_cost(c), scan, rtol=3e-2, atol=3e-1)


def test_homography_coeffs_match_jax():
    """Same f32 algebra in both frameworks (matrix inverses and einsums
    may round differently): rtol 1e-5."""
    c = _case(seed=3, t_scale=1.0, rot=0.2)
    frustum, k2s, intr, pr, pt, input_size = c["geo"]
    want = jcv.homography_coeffs(
        jnp.asarray(frustum), jnp.asarray(k2s), jnp.asarray(intr),
        jnp.asarray(pr), jnp.asarray(pt), input_size, frustum.shape[1:3])
    for got, ref in zip(c["coef"], want):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_stereo_cost_volume_softmax_matches_jax():
    """The public wrapper: softmax(-cost) over D. Against JAX's CPU path
    (the bf16 gather), a cost error of up to 0.3 moves a probability by
    at most ~0.3 of itself; atol 0.05 on probabilities."""
    c = _case(seed=5, t_scale=0.5)
    frustum, k2s, intr, pr, pt, input_size = c["geo"]
    t = torch.from_numpy
    got = tcv.stereo_cost_volume(
        t(c["curr"]), t(c["prev"]), t(frustum), t(k2s), t(intr), t(pr),
        t(pt), input_size, BIAS).numpy()
    want = np.asarray(jcv.stereo_cost_volume(
        jnp.asarray(c["curr"]), jnp.asarray(c["prev"]), jnp.asarray(frustum),
        jnp.asarray(k2s), jnp.asarray(intr), jnp.asarray(pr),
        jnp.asarray(pt), input_size, BIAS, impl="scan"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.sum(2), 1.0, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=5e-2)


def test_cost_volume_behind_camera_is_zero_warp_plus_bias():
    """A candidate behind the sweep camera warps to all zeros, so its
    cost is sum_c |curr| + bias."""
    c = _case(**GEOMETRIES["near_planes"])
    az, bz = c["coef"][0], c["coef"][1]
    den = c["depths"][None, None, :, None, None] * az[:, :, None] \
        + bz[:, :, None, None, None]
    behind = den < 1e-3
    assert behind.any()
    zero_warp = np.abs(c["curr"]).sum(-1)[:, :, None] + BIAS
    got = _port_cost(c)
    np.testing.assert_allclose(got[behind],
                               np.broadcast_to(zero_warp, got.shape)[behind],
                               rtol=1e-6)


def test_cost_volume_wrapper_rejects_other_devices():
    """Only CPU tensors take the plain version and CUDA tensors the
    kernel (the custom op `ocrfdet::cost_volume`): meta tensors get the
    op's shape function and launch nothing, and a backend the op has no
    kernel for (sparse tensors) raises."""
    c = _case(seed=0)
    host = [torch.from_numpy(np.asarray(a))
            for a in (c["curr"], c["prev"], c["depths"], *c["coef"])]
    before = tcv.KERNEL.launches
    out = tcv.cost_volume(*[a.to("meta") for a in host], BIAS)
    B, N, H, W, _ = host[0].shape
    assert out.device.type == "meta" and out.dtype == torch.float32
    assert tuple(out.shape) == (B, N, host[2].shape[0], H, W)
    assert tcv.KERNEL.launches == before
    with pytest.raises(NotImplementedError, match="Sparse"):
        tcv.cost_volume(host[0].to_sparse(), *host[1:], BIAS)


# --------------------------------------------------------------------
# K2: BEV pool
# --------------------------------------------------------------------

def _golden_case():
    """tests/test_bev_pool.py::golden_case: the reference kernel's
    hand-computed case, loss 4.4 with exact gradients."""
    depth = np.array([0.3, 0.4, 0.2, 0.1, 0.7, 0.6, 0.8, 0.9],
                     dtype=np.float32).reshape(1, 1, 2, 2, 2)
    feat = np.ones((1, 1, 2, 2, 2), dtype=np.float32)
    vox_idx = np.zeros((1, 1, 2, 2, 2, 3), dtype=np.int32)
    valid = np.zeros((1, 1, 2, 2, 2), dtype=bool)
    for (d, h, w), (x, y) in [((0, 0, 0), (0, 0)), ((0, 0, 1), (1, 0)),
                              ((1, 0, 0), (0, 0)), ((1, 1, 0), (1, 0))]:
        valid[0, 0, d, h, w] = True
        vox_idx[0, 0, d, h, w] = (x, y, 0)
    return depth, feat, vox_idx, valid, (2, 2, 1)


def test_bev_pool_golden_forward_and_grad():
    depth, feat, vox_idx, valid, bev_size = _golden_case()
    d = torch.from_numpy(depth).requires_grad_()
    f = torch.from_numpy(feat).requires_grad_()
    loss = tbp.bev_pool_lss(d, f, torch.from_numpy(vox_idx),
                            torch.from_numpy(valid), bev_size).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), 4.4, rtol=1e-6)
    np.testing.assert_allclose(d.grad.numpy().ravel(),
                               [2, 2, 0, 0, 2, 0, 2, 0], atol=1e-6)
    np.testing.assert_allclose(f.grad.numpy().ravel(),
                               [1.0, 1.0, 0.4, 0.4, 0.8, 0.8, 0, 0],
                               atol=1e-6)


def _random_pool_case(seed, B=2, N=3, D=4, fH=3, fW=5, C=6,
                      bev_size=(4, 3, 2)):
    rng = np.random.default_rng(seed)
    depth = rng.random((B, N, D, fH, fW)).astype(np.float32)
    feat = rng.normal(size=(B, N, fH, fW, C)).astype(np.float32)
    vox_idx = np.stack([rng.integers(0, s, (B, N, D, fH, fW))
                        for s in bev_size], -1).astype(np.int32)
    valid = rng.random((B, N, D, fH, fW)) < 0.7
    return depth, feat, vox_idx, valid, bev_size


@pytest.mark.parametrize("impl,bev_size", [("segsum", (4, 3, 2)),
                                           ("pallas", (3, 3, 1)),
                                           ("segsum", (5, 4, 1))])
def test_bev_pool_lss_matches_jax(impl, bev_size):
    """fp32 sums of a handful of terms in another order: rtol 1e-5."""
    depth, feat, vox_idx, valid, bev_size = _random_pool_case(
        1, bev_size=bev_size)
    want = np.asarray(jbp.bev_pool_lss(
        jnp.asarray(depth), jnp.asarray(feat), jnp.asarray(vox_idx),
        jnp.asarray(valid), bev_size, impl=impl))
    got = tbp.bev_pool_lss(torch.from_numpy(depth), torch.from_numpy(feat),
                           torch.from_numpy(vox_idx),
                           torch.from_numpy(valid), bev_size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bev_pool_lss_grads_match_jax():
    """Gradients of the plain version (autograd through gather and
    index_add) against JAX segsum's: rtol 1e-5."""
    import jax
    depth, feat, vox_idx, valid, bev_size = _random_pool_case(2)
    g = np.random.default_rng(3).normal(
        size=(depth.shape[0], bev_size[1], bev_size[0],
              bev_size[2] * feat.shape[-1])).astype(np.float32)

    def jloss(d, f):
        out = jbp.bev_pool_lss(d, f, jnp.asarray(vox_idx),
                               jnp.asarray(valid), bev_size, impl="segsum")
        return jnp.sum(out * g)
    jd, jf = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(depth),
                                             jnp.asarray(feat))
    d = torch.from_numpy(depth).requires_grad_()
    f = torch.from_numpy(feat).requires_grad_()
    out = tbp.bev_pool_lss(d, f, torch.from_numpy(vox_idx),
                           torch.from_numpy(valid), bev_size)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5)


def test_bev_pool_points_drops_invalid_cells():
    """Points with cell id == cells contribute nothing."""
    w = torch.tensor([[1.0, 2.0, 3.0]])
    pix = torch.tensor([[0, 1, 1]], dtype=torch.int32)
    cell = torch.tensor([[1, 2, 1]], dtype=torch.int32)   # 2 == cells
    feat = torch.tensor([[[1.0, 10.0], [100.0, 1000.0]]])
    out = tbp.bev_pool_points(w, pix, cell, feat, cells=2)
    np.testing.assert_allclose(out.numpy(),
                               [[[0.0, 0.0], [301.0, 3010.0]]])


def test_bev_pool_points_wrapper_rejects_other_devices():
    """As K1's: meta tensors get `ocrfdet::bev_pool`'s shape function and
    launch nothing, sparse tensors raise."""
    args = [torch.as_tensor(a) for a in (
        np.ones((1, 2), np.float32), np.zeros((1, 2), np.int32),
        np.zeros((1, 2), np.int32), np.ones((1, 1, 3), np.float32))]
    before = tbp.KERNEL.launches
    out = tbp.bev_pool_points(*[a.to("meta") for a in args], 4)
    assert out.device.type == "meta" and tuple(out.shape) == (1, 4, 3)
    assert tbp.KERNEL.launches == before
    with pytest.raises(NotImplementedError, match="Sparse"):
        tbp.bev_pool_points(args[0].to_sparse(), *args[1:], 4)
