"""K2's index preparation, `ocrfdet_tpu_torch/ops/bev_pool.py::
cell_intervals`, on the CPU.

The forward kernel (csrc/bev_pool.cu) pools, for each key k = b *
(cells + 1) + cell, the points perm[offsets[k]:offsets[k + 1]] in that
order. Here `cell_intervals` is held to a numpy brute force (the
permutation must be the stable one, exactly, and the offsets must cover
exactly the valid points of each (b, cell)), and pooling its intervals
in a few lines must give the plain version (`bev_pool_points_plain`) and
the JAX Pallas `bev_pool_points` in interpret mode: rtol 1e-6 / atol
1e-6 (both add the same weighted rows one after the other in the points'
order, as the intervals do).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu.ops import bev_pool_pallas as jbpp
from ocrfdet_tpu_torch.ops import bev_pool as tbp


def _case(name, seed=0):
    """(w [B,P], pix [B,P], cell [B,P], feat [B,npix,C], cells)."""
    rng = np.random.default_rng(seed)
    B, P, npix, C, cells = 1, 200, 23, 5, 16
    if name == "ragged":
        B, P = 2, 1000 + 7                 # P not a multiple of 32
    if name == "b2_different_cells":
        B = 2
    if name == "empty_cells":
        cells, P = 64, 40
    cell = rng.integers(0, cells, (B, P))
    if name == "invalid_points":
        cell = np.where(rng.random((B, P)) < 0.4, cells, cell)
    if name == "one_cell_most":
        cell = np.where(rng.random((B, P)) < 0.9, 5, cell)
    if name == "b2_different_cells":       # disjoint cells per sample
        cell[0] = rng.integers(0, cells // 2, P)
        cell[1] = rng.integers(cells // 2, cells, P)
    if name == "all_invalid_sample":
        B = 2
        cell = np.stack([rng.integers(0, cells, P), np.full(P, cells)])
    if name == "out_of_range_ids":         # counted as invalid
        cell = rng.integers(-3, cells + 4, (B, P))
    w = rng.random((cell.shape[0], P), dtype=np.float32)
    pix = rng.integers(0, npix, (cell.shape[0], P)).astype(np.int32)
    feat = rng.standard_normal((cell.shape[0], npix, C), dtype=np.float32)
    return w, pix, cell.astype(np.int32), feat, cells


POOL_CASES = ["random", "invalid_points", "empty_cells", "one_cell_most",
              "b2_different_cells", "ragged", "all_invalid_sample"]
CASES = POOL_CASES + ["out_of_range_ids"]


def _brute_intervals(cell, cells):
    """The stable order of the flat points b*P + p by (b, cell), invalid
    cells (outside [0, cells)) last in each sample, and each key's start."""
    B, P = cell.shape
    order, offsets = [], [0]
    for b in range(B):
        c = np.where((cell[b] >= 0) & (cell[b] < cells), cell[b], cells)
        for k in range(cells + 1):
            order.extend(b * P + np.nonzero(c == k)[0])   # ascending p
            offsets.append(len(order))
    return np.asarray(order), np.asarray(offsets)


@pytest.mark.parametrize("name", CASES)
def test_cell_intervals_match_brute_force(name):
    _, _, cell, _, cells = _case(name)
    perm, offsets = tbp.cell_intervals(torch.from_numpy(cell), cells)
    assert perm.dtype == torch.int64 and offsets.dtype == torch.int32
    want_perm, want_offsets = _brute_intervals(cell, cells)
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)
    # each valid (b, cell) interval holds exactly that cell's points
    B, P = cell.shape
    flat = cell.reshape(-1)
    for k in range(B * (cells + 1)):
        b, c = divmod(k, cells + 1)
        got = perm[offsets[k]:offsets[k + 1]].numpy()
        if c < cells:
            assert set(got) == set(b * P + np.nonzero(cell[b] == c)[0])
            assert (flat[got] == c).all()


def _pool_intervals(w, pix, cell, feat, cells):
    """Pool each (b, cell) interval of cell_intervals one point after the
    other in fp32 (the forward kernel's arithmetic, in one chunk)."""
    B, P = w.shape
    perm, offsets = tbp.cell_intervals(torch.from_numpy(cell), cells)
    perm, offsets = perm.numpy(), offsets.numpy()
    out = np.zeros((B, cells, feat.shape[-1]), np.float32)
    for b in range(B):
        for c in range(cells):
            k = b * (cells + 1) + c
            idx = perm[offsets[k]:offsets[k + 1]] - b * P
            rows = feat[b, pix[b, idx]] * w[b, idx, None]
            if len(idx):
                out[b, c] = np.add.accumulate(rows, axis=0)[-1]
    return out


@pytest.mark.parametrize("name", POOL_CASES)
def test_pooled_intervals_match_plain_and_jax(name):
    w, pix, cell, feat, cells = _case(name, seed=1)
    got = _pool_intervals(w, pix, cell, feat, cells)
    plain = tbp.bev_pool_points_plain(
        torch.from_numpy(w), torch.from_numpy(pix), torch.from_numpy(cell),
        torch.from_numpy(feat), cells).numpy()
    jax_out = np.asarray(jbpp.bev_pool_points(
        jnp.asarray(w), jnp.asarray(pix), jnp.asarray(cell),
        jnp.asarray(feat), cells))
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, jax_out, rtol=1e-6, atol=1e-6)
    empty = np.ones((w.shape[0], cells), bool)
    for b in range(w.shape[0]):
        empty[b, cell[b][cell[b] < cells]] = False
    assert (got[empty] == 0).all()
