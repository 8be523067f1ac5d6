"""The backward of kernel K4 (voxel point sample), its binning and its
summation order, on the CPU: `ocrfdet_tpu_torch/ops/point_sample.py::
point_sample_order_plain` and `point_sample_backward_walk_plain`.

The backward kernel (csrc/point_sample.cu) bins every point with a tap
in the image by output tile, then one block a tile sorts its bin's keys
(base tap, point) and walks, for each texel, the points of the four
base taps that reach it in the order (v-1, u-1), (v-1, u), (v, u-1),
(v, u), each by point index. Here:

* the binning's plain version against a numpy brute force that names
  the tiles a point's in-image taps fall in: the same bins, keys and
  ends, exactly; out-of-image points in no bin;
* the bins walked tile by tile in chunks of sorted keys, as the kernel
  walks them (in numpy, fp32), against the plain walk: the same bits,
  whatever the tile and chunk size;
* the plain walk against the plain version's autograd (rtol 1e-6, atol
  1e-6 of the gradient's scale: the autograd sums each tap's scatter
  apart and then adds the four), against `jax.vjp` of the JAX
  `point_sample_ref` in f32 (rtol 1e-5, atol 1e-5 of the scale: other
  fp32 sum orders) and against the Pallas `point_sample_mm` in
  interpret mode (rtol 3e-2, atol 2e-2: it takes bf16 products and
  returns a bf16 gradient).

Cases: points in (-1, 0) on both axes, on the last column and row,
integer points (taps of weight 0), far-off points, one pixel holding
hundreds of points, and no point at all.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu.ops import point_sample as jps
from ocrfdet_tpu_torch.ops import point_sample as tps


def _case(name, seed=0, BN=3, H=40, W=56, C=4, P=3000):
    """px, py [BN,P] f32, dout [BN,P,C] f32 and the map shape."""
    rng = np.random.default_rng(seed)
    if name == "empty":
        P = 0
    px = rng.uniform(-3, W + 3, (BN, P))
    py = rng.uniform(-3, H + 3, (BN, P))
    k = P // 10
    if name != "empty":
        px[:, :k] = rng.uniform(-1, 0, (BN, k))          # column -1
        py[:, k:2 * k] = rng.uniform(-1, 0, (BN, k))     # row -1
        px[:, 2 * k:3 * k] = rng.uniform(-1, 0, (BN, k))  # both
        py[:, 2 * k:3 * k] = rng.uniform(-1, 0, (BN, k))
        px[:, 3 * k:4 * k] = rng.uniform(W - 1, W, (BN, k))
        py[:, 4 * k:5 * k] = rng.uniform(H - 1, H, (BN, k))
        px[:, 5 * k:6 * k] = rng.integers(-1, W + 1, (BN, k))
        py[:, 5 * k:6 * k] = rng.integers(-1, H + 1, (BN, k))
        px[:, 6 * k] = W - 1                              # exactly on
        py[:, 6 * k] = H - 1                              # the corner
        px[:, 6 * k + 1] = -1e7
        py[:, 6 * k + 2] = 3e6
    if name == "hot_pixel":                # hundreds of points, one pixel
        hot = slice(7 * k, min(7 * k + 400, P))
        px[:, hot] = 15 + rng.uniform(0, 1, px[:, hot].shape)
        py[:, hot] = 7 + rng.uniform(0, 1, py[:, hot].shape)
    if name == "tile_edges":               # base taps on tile seams
        px[:, 7 * k:8 * k] = (rng.integers(0, W // 8, (BN, k)) * 8 - 1
                              + rng.uniform(0, 1, (BN, k)))
        py[:, 7 * k:8 * k] = (rng.integers(0, H // 8, (BN, k)) * 8 - 1
                              + rng.uniform(0, 1, (BN, k)))
    dout = rng.standard_normal((BN, P, C))
    return (px.astype(np.float32), py.astype(np.float32),
            dout.astype(np.float32), (BN, H, W, C))


CASES = ["random", "hot_pixel", "tile_edges", "empty"]


def _weights(px, py, H, W):
    """x0, y0 (float) and the four tap weights [BN,P,4] in f32, the
    plain version's separately rounded operations, in numpy."""
    def axis(t0, tt, n):
        one = np.float32(1)
        w0 = (one - tt) * ((t0 >= 0) & (t0 <= n - 1)).astype(np.float32)
        w1 = tt * ((t0 + 1 >= 0) & (t0 + 1 <= n - 1)).astype(np.float32)
        return w0, w1
    x0, y0 = np.floor(px), np.floor(py)
    wx0, wx1 = axis(x0, px - x0, W)
    wy0, wy1 = axis(y0, py - y0, H)
    return x0, y0, np.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1],
                            -1)


def _brute_bins(px, py, H, W, tile):
    """Every (bin, key) of the binning, from the tiles that a point's
    in-image tap columns and rows fall in, sorted; each bin's inclusive
    end."""
    BN, P = px.shape
    nty, ntx = -(-H // tile), -(-W // tile)
    items = []
    for b in range(BN):
        for p in range(P):
            x0, y0 = int(np.floor(max(min(px[b, p], 1e9), -1e9))), \
                int(np.floor(max(min(py[b, p], 1e9), -1e9)))
            cols = {u // tile for u in (x0, x0 + 1) if 0 <= u < W}
            rows = {v // tile for v in (y0, y0 + 1) if 0 <= v < H}
            for ty in rows:
                for tx in cols:
                    code = ((y0 - (ty * tile - 1)) * (tile + 1)
                            + x0 - (tx * tile - 1))
                    assert 0 <= code < (tile + 1) ** 2
                    items.append(((b * nty + ty) * ntx + tx,
                                  (code << 32) | p))
    items.sort()
    counts = np.zeros(BN * nty * ntx, np.int64)
    for b, _ in items:
        counts[b] += 1
    return np.cumsum(counts), np.array([k for _, k in items], np.int64)


@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("name", ["random", "tile_edges", "empty"])
def test_order_plain_matches_brute_force(name, tile):
    px, py, _, (BN, H, W, C) = _case(name, BN=2, P=600)
    ends, order = tps.point_sample_order_plain(
        torch.from_numpy(px), torch.from_numpy(py), H, W, tile)
    want_ends, want_order = _brute_bins(px, py, H, W, tile)
    assert ends.dtype == order.dtype == torch.int64
    np.testing.assert_array_equal(ends.numpy(), want_ends)
    np.testing.assert_array_equal(order.numpy(), want_order)
    # every point with an in-image tap is in its base tap's bin at its
    # base tap's code; the others are in no bin
    x0, y0 = np.floor(px), np.floor(py)
    inside = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    nty, ntx = -(-H // tile), -(-W // tile)
    ends_np, order_np = ends.numpy(), order.numpy()
    starts = np.concatenate([[0], ends_np[:-1]])
    points = order_np & 0xFFFFFFFF
    seen = np.zeros_like(inside)
    for b in range(BN * nty * ntx):
        bn = b // (nty * ntx)
        ty, tx = divmod(b % (nty * ntx), ntx)
        for key in order_np[starts[b]:ends_np[b]]:
            p, code = key & 0xFFFFFFFF, key >> 32
            by, bx = divmod(int(code), tile + 1)
            assert (ty * tile - 1 + by, tx * tile - 1 + bx) == (
                y0[bn, p], x0[bn, p])
            if (ty, tx) == (max(y0[bn, p], 0) // tile,
                            max(x0[bn, p], 0) // tile):
                assert not seen[bn, p]
                seen[bn, p] = True
    np.testing.assert_array_equal(seen, inside)
    if name != "empty":
        assert 0 < len(np.unique(points)) and not inside.all()


def _tile_walk(px, py, dout, shape, tile, chunk):
    """The backward kernel's walk in numpy, fp32: per bin of
    `point_sample_order_plain`, chunks of `chunk` sorted keys; per chunk
    each texel walks the runs of its four base taps in order."""
    BN, H, W, C = shape
    ends, order = tps.point_sample_order_plain(
        torch.from_numpy(px), torch.from_numpy(py), H, W, tile)
    ends, order = ends.numpy(), order.numpy()
    _, _, w = _weights(px, py, H, W)
    nty, ntx = -(-H // tile), -(-W // tile)
    F = tile + 1
    dmap = np.zeros(shape, np.float32)
    for b in range(BN * nty * ntx):
        bn = b // (nty * ntx)
        ty, tx = divmod(b % (nty * ntx), ntx)
        keys = order[(ends[b - 1] if b else 0):ends[b]]
        acc = np.zeros((tile, tile, C), np.float32)
        for c0 in range(0, len(keys), chunk):
            codes = keys[c0:c0 + chunk] >> 32
            points = keys[c0:c0 + chunk] & 0xFFFFFFFF
            for lv in range(tile):
                for lu in range(tile):
                    code = lv * F + lu
                    for run, tap in ((code, 3), (code + 1, 2),
                                     (code + F, 1), (code + F + 1, 0)):
                        for p in points[codes == run]:
                            if w[bn, p, tap] != 0:
                                acc[lv, lu] = acc[lv, lu] + (
                                    w[bn, p, tap] * dout[bn, p])
        v1, u1 = min(H, (ty + 1) * tile), min(W, (tx + 1) * tile)
        dmap[bn, ty * tile:v1, tx * tile:u1] = \
            acc[:v1 - ty * tile, :u1 - tx * tile]
    return dmap


@pytest.mark.parametrize("tile,chunk", [(8, 16), (16, 512), (16, 7)])
@pytest.mark.parametrize("name", ["random", "hot_pixel"])
def test_tiles_walked_in_chunks_give_the_walks_bits(name, tile, chunk):
    px, py, dout, shape = _case(name, BN=2, H=24, W=40, P=900, seed=1)
    got = _tile_walk(px, py, dout, shape, tile, chunk)
    want = tps.point_sample_backward_walk_plain(
        torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(dout),
        shape).numpy()
    np.testing.assert_array_equal(got, want)


def _plain_grad(px, py, dout, shape):
    maps = torch.zeros(shape, dtype=torch.float32, requires_grad=True)
    out = tps.point_sample_points_plain(maps, torch.from_numpy(px),
                                        torch.from_numpy(py))
    out.backward(torch.from_numpy(dout))
    return maps.grad.numpy()


def _walk(px, py, dout, shape):
    return tps.point_sample_backward_walk_plain(
        torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(dout),
        shape).numpy()


@pytest.mark.parametrize("name", CASES)
def test_walk_matches_plain_autograd(name):
    px, py, dout, shape = _case(name)
    got, want = _walk(px, py, dout, shape), _plain_grad(px, py, dout, shape)
    assert got.dtype == np.float32 and got.shape == shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)
    if name == "empty":
        assert not got.any()
    # the backward wrapper on CPU tensors is the walk
    via = tps.point_sample_points_backward(
        torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(dout),
        shape).numpy()
    np.testing.assert_array_equal(via, got)


def _jax_grad(fn, px, py, dout, shape):
    BN, H, W, C = shape
    maps = jnp.zeros((1, BN, H, W, C), jnp.float32)
    _, vjp = jax.vjp(lambda m: fn(m, jnp.asarray(px)[None],
                                  jnp.asarray(py)[None]), maps)
    (g,) = vjp(jnp.asarray(dout)[None])
    return np.asarray(g, np.float32)[0]


@pytest.mark.parametrize("name", ["random", "hot_pixel", "tile_edges"])
def test_walk_matches_jax_point_sample_ref_vjp(name):
    px, py, dout, shape = _case(name, seed=2)
    want = _jax_grad(jps.point_sample_ref, px, py, dout, shape)
    got = _walk(px, py, dout, shape)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_walk_matches_pallas_interpret_vjp():
    px, py, dout, shape = _case("random", seed=3, BN=2, H=16, W=24, P=700)
    want = _jax_grad(
        lambda m, x, y: jps.point_sample_mm(m, x, y, interpret=True),
        px, py, dout, shape)
    got = _walk(px, py, dout, shape)
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=2e-2)


def test_edge_taps_reach_texel_zero_and_clamped_taps_add_nothing():
    """px in (-1, 0): only the tap u = 0 gets w = 1 - |px|; a point at
    x0 = W - 1 adds only to u = W - 1 (its clamped right tap weighs 0),
    the same on the rows; an integer point adds to its own texel alone."""
    H, W = 3, 5
    px = np.asarray([[-0.25, W - 1 + 0.5, 2.0, 1.5]], np.float32)
    py = np.asarray([[1.0, 1.0, -0.5, H - 1 + 0.25]], np.float32)
    dout = np.asarray([[[1.0], [2.0], [4.0], [8.0]]], np.float32)
    got = _walk(px, py, dout, (1, H, W, 1))[0, :, :, 0]
    want = np.zeros((H, W), np.float32)
    want[1, 0] += 0.75 * 1.0
    want[1, W - 1] += 0.5 * 2.0
    want[0, 2] += 0.5 * 4.0
    want[H - 1, 1] += 0.5 * 0.75 * 8.0
    want[H - 1, 2] += 0.5 * 0.75 * 8.0
    np.testing.assert_array_equal(got, want)
