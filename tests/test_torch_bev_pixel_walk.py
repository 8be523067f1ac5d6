"""The walk of K2's backward kernel, `ocrfdet_tpu_torch/csrc/bev_pool.cu`,
on the CPU.

The backward kernel owns one (b, pixel) per warp and walks the pixel's
points in ascending p: it adds w * g[cell] into the pixel's dfeat row
point after point (product and sum rounded on their own) and writes dw =
<feat[pix], g[cell]> for every point, 0 for a point outside the grid or
on a pixel outside [0, npix). It names a pixel's points in one of two
ways: in closed form for the LSS layout of `lss_points` (every (b,
camera n, pixel hw) owns the D points p = (n * D + d) * HW + hw), or
from the points sorted by pixel, `cell_intervals(pix_id, npix)`. Here
`lss_points`'s pix stream is held to the closed form, the two ways are
held to name the same points in the same order, and the rows walked in
numpy (float32) are held to the plain version's autograd and to the
gradients of JAX's Pallas `bev_pool_points` (interpret mode on the CPU,
as tests/test_bev_pool.py runs it): rtol 1e-5, atol 1e-5 of each
gradient's scale (other fp32 sum orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu.ops import bev_pool_pallas as jbpp
from ocrfdet_tpu_torch.ops import bev_pool as tbp

B, N, D, FH, FW, C = 2, 3, 5, 2, 3, 4
BEV = (4, 3, 2)                       # X, Y, Z: 24 cells


def _lss_case(name, seed=0):
    """K2's point streams of `lss_points` (w, pix, cell [B,P], feat
    [B,npix,C], cells) from random depth, context and voxel indices."""
    rng = np.random.default_rng(seed)
    shape = (B, N, D, FH, FW)
    depth = rng.random(shape, dtype=np.float32)
    feat = rng.standard_normal((B, N, FH, FW, C), dtype=np.float32)
    vox = np.stack([rng.integers(0, n, shape) for n in BEV], -1)
    valid = rng.random(shape) < 0.5
    if name == "all_valid":
        valid[:] = True
    if name == "none_valid":
        valid[:] = False
    if name == "one_cell":              # every valid point in cell 5
        vox[..., 0], vox[..., 1], vox[..., 2] = 1, 1, 0
    return tbp.lss_points(torch.from_numpy(depth), torch.from_numpy(feat),
                          torch.from_numpy(vox), torch.from_numpy(valid),
                          BEV)


def _closed_form():
    """{(b, pixel): its points in ascending p} of the LSS layout."""
    HW = FH * FW
    return {(b, n * HW + hw): [(n * D + d) * HW + hw for d in range(D)]
            for b in range(B) for n in range(N) for hw in range(HW)}


def _sorted(pix, npix):
    """{(b, pixel): its points} from cell_intervals(pix, npix), the
    pixels outside [0, npix) under pixel npix."""
    Bp, P = pix.shape
    perm, offsets = tbp.cell_intervals(torch.from_numpy(pix), npix)
    perm, offsets = perm.numpy(), offsets.numpy()
    return {(b, px): list(perm[offsets[k]:offsets[k + 1]] - b * P)
            for b in range(Bp) for px in range(npix + 1)
            for k in [b * (npix + 1) + px]}


def _walk(w, cell, feat, g, cells, points):
    """(dw, dfeat) by walking each pixel's points in the given order, as
    the kernel does, in float32."""
    Bp, P = w.shape
    npix = feat.shape[1]
    dw = np.full((Bp, P), np.nan, np.float32)
    dfeat = np.zeros_like(feat)
    for (b, px), pts in points.items():
        acc = np.zeros(feat.shape[-1], np.float32)
        for p in pts:
            c = cell[b, p]
            if px >= npix or not 0 <= c < cells:
                dw[b, p] = 0.0
                continue
            acc = acc + w[b, p] * g[b, c]          # float32, each rounded
            dw[b, p] = np.dot(feat[b, px], g[b, c])
        if px < npix:
            dfeat[b, px] = acc
    assert not np.isnan(dw).any()              # every point written once
    return dw, dfeat


def _plain_grads(w, pix, cell, feat, cells, g):
    t = [torch.from_numpy(x) for x in (w, pix, cell, feat)]
    t[0].requires_grad_()
    t[3].requires_grad_()
    out = tbp.bev_pool_points_plain(t[0], t[1], t[2], t[3], cells)
    dw, dfeat = torch.autograd.grad(out, (t[0], t[3]), torch.from_numpy(g))
    return dw.numpy(), dfeat.numpy()


def _assert_close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30))


def test_lss_points_pix_is_the_closed_form_layout():
    w, pix, cell, feat = (t.numpy() for t in _lss_case("random")[:4])
    HW = FH * FW
    P = N * D * HW
    assert pix.shape == (B, P) and feat.shape == (B, N * HW, C)
    n, d, hw = np.meshgrid(np.arange(N), np.arange(D), np.arange(HW),
                           indexing="ij")
    p = ((n * D + d) * HW + hw).reshape(-1)
    assert np.array_equal(np.sort(p), np.arange(P))   # each point once
    for b in range(B):
        np.testing.assert_array_equal(pix[b, p], (n * HW + hw).reshape(-1))


@pytest.mark.parametrize("name", ["random", "all_valid", "none_valid",
                                  "one_cell"])
def test_pixel_walks_give_the_gradients(name):
    """Walked in closed form and from cell_intervals(pix, npix), the same
    points in the same order and the same bits; both give the plain
    autograd's and JAX's Pallas gradients."""
    w, pix, cell, feat, cells = _lss_case(name, seed=1)
    w, pix, cell, feat = (t.numpy() for t in (w, pix, cell, feat))
    npix = feat.shape[1]
    g = np.random.default_rng(2).standard_normal(
        (B, cells, C), dtype=np.float32)
    closed, by_pixel = _closed_form(), _sorted(pix, npix)
    assert all(not by_pixel[b, npix] for b in range(B))
    assert {k: v for k, v in by_pixel.items() if v} == closed
    got = _walk(w, cell, feat, g, cells, closed)
    again = _walk(w, cell, feat, g, cells, by_pixel)
    assert all(np.array_equal(a, b) for a, b in zip(got, again))

    _assert_close(got, _plain_grads(w, pix, cell, feat, cells, g))
    _, vjp = jax.vjp(lambda w_, f_: jbpp.bev_pool_points(
        w_, jnp.asarray(pix), jnp.asarray(cell), f_, cells),
        jnp.asarray(w), jnp.asarray(feat))
    jdw, jdfeat = vjp(jnp.asarray(g))
    _assert_close(got, (np.asarray(jdw), np.asarray(jdfeat)))
    if name == "none_valid":
        assert not got[0].any() and not got[1].any()


@pytest.mark.parametrize("name", ["random", "pix_out_of_range"])
def test_sorted_walk_on_any_stream(name):
    """Points in no layout, walked from cell_intervals(pix, npix): the
    plain autograd's gradients; a point whose pix lies outside [0, npix)
    gets dw = 0 and adds to no row, as a point outside the grid (the
    plain version, which cannot gather such a pix, is given those points
    outside the grid on pixel 0)."""
    rng = np.random.default_rng(3)
    Bp, P, npix, cells = 2, 300, 17, 11
    w = rng.random((Bp, P), dtype=np.float32)
    pix = rng.integers(0, npix, (Bp, P)).astype(np.int32)
    cell = rng.integers(0, cells + 1, (Bp, P)).astype(np.int32)
    feat = rng.standard_normal((Bp, npix, C), dtype=np.float32)
    g = rng.standard_normal((Bp, cells, C), dtype=np.float32)
    out = np.zeros_like(pix, bool)
    if name == "pix_out_of_range":
        out = rng.random((Bp, P)) < 0.2
        pix = np.where(out, rng.choice([-1, npix, npix + 3], (Bp, P)),
                       pix).astype(np.int32)
    points = _sorted(pix, npix)
    assert sorted(sum(points.values(), [])) == sorted(
        list(range(P)) * Bp)                    # each point once
    got = _walk(w, cell, feat, g, cells, points)
    want = _plain_grads(w, np.where(out, 0, pix).astype(np.int32),
                        np.where(out, cells, cell).astype(np.int32), feat,
                        cells, g)
    _assert_close(got, want)
    assert not got[0][out].any()
