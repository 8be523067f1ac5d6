"""The ordering of K3's backward, `ocrfdet_tpu_torch/ops/ht_pool.py::
ht_pool_order_plain`, on the CPU.

The backward kernel (csrc/ht_pool.cu) walks, for each row r = (b * N +
n) * HW + pix, the keys order[ends[r-1]:ends[r]] (key = di * Zh * Nq +
z * Nq + q) of the row's valid points in that order: by depth bin, then
by point. Here the plain version, which the card's ordering must equal
exactly (tests/test_torch_kernels.py), is held to a numpy brute force
that walks every point: the same ends and the same keys, exactly.
Walking its rows as the kernel does (a run of points per depth bin)
gives the gradients of the plain HT pool's autograd and of JAX's f32
reference `ht_pool_ref` (rtol 1e-5, atol 1e-5 of each gradient's scale:
other fp32 sum orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu.ops import ht_pool as jhp
from ocrfdet_tpu_torch.ops import ht_pool as thp


def _case(name, seed=0):
    """(pix, di, wv [B,N,Zh,Nq], HW, D)."""
    rng = np.random.default_rng(seed)
    B, N, Zh, Nq, HW, D = 1, 3, 4, 37, 20, 6
    if name == "b2":
        B = 2
    pix = rng.integers(0, HW, (B, N, Zh, Nq))
    di = rng.integers(0, D, (B, N, Zh, Nq))
    wv = (rng.random((B, N, Zh, Nq)) > 0.6).astype(np.float32)
    if name == "all_invalid":
        wv[:] = 0.0
    if name == "one_full_row":          # every point valid, one pixel
        wv[:] = 1.0
        pix[:] = 7
    if name == "few_pixels":            # most rows empty, runs per bin
        pix = (pix % 3) * 5
        di = di % 2
    if name == "weights":               # wv other than 0 and 1
        wv = wv * rng.uniform(0.5, 2.0, wv.shape).astype(np.float32)
    return (pix.astype(np.int32), di.astype(np.int32), wv, HW, D)


CASES = ["random", "b2", "all_invalid", "one_full_row", "few_pixels",
         "weights"]


def _brute(pix, di, wv, HW, D):
    """Every valid point's (row, key), sorted; each row's inclusive end."""
    B, N, Zh, Nq = pix.shape
    items = []
    for b in range(B):
        for n in range(N):
            for z in range(Zh):
                for q in range(Nq):
                    if wv[b, n, z, q] != 0:
                        row = (b * N + n) * HW + pix[b, n, z, q]
                        key = di[b, n, z, q] * Zh * Nq + z * Nq + q
                        items.append((row, key))
    items.sort()
    counts = np.zeros(B * N * HW, np.int64)
    for row, _ in items:
        counts[row] += 1
    return np.cumsum(counts), np.array([k for _, k in items], np.int64)


@pytest.mark.parametrize("name", CASES)
def test_ht_order_plain_matches_brute_force(name):
    pix, di, wv, HW, D = _case(name)
    ends, order = thp.ht_pool_order_plain(
        torch.from_numpy(pix), torch.from_numpy(di), torch.from_numpy(wv),
        HW, D)
    want_ends, want_order = _brute(pix, di, wv, HW, D)
    assert ends.dtype == order.dtype == torch.int32
    np.testing.assert_array_equal(ends.numpy(), want_ends)
    np.testing.assert_array_equal(order.numpy(), want_order)


def _walk(dep, ctx, wv, dout, ends, order, Zh, Nq):
    """The backward kernel's walk in numpy (float32): per row, per run of
    one depth bin, S = sum wv dout[q]; ddep = <ctx, S>, dctx += dep S."""
    B, N, HW, D = dep.shape
    C = ctx.shape[-1]
    ZQ = Zh * Nq
    ddep = np.zeros((B * N * HW, D), np.float32)
    dctx = np.zeros((B * N * HW, C), np.float32)
    dep, ctx = dep.reshape(-1, D), ctx.reshape(-1, C)
    wv = wv.reshape(B * N, ZQ)
    start = 0
    for r, end in enumerate(ends):
        bn, b = r // HW, r // HW // N
        runs = {}
        for key in order[start:end]:
            d, zq = divmod(int(key), ZQ)
            runs.setdefault(d, np.zeros(C, np.float32))
            runs[d] += wv[bn, zq] * dout[b, zq % Nq]
        for d, S in runs.items():
            ddep[r, d] = ctx[r] @ S
            dctx[r] += dep[r, d] * S
        start = end
    return ddep.reshape(B, N, HW, D), dctx.reshape(B, N, HW, C)


@pytest.mark.parametrize("name", ["random", "b2", "few_pixels", "weights"])
def test_ht_order_walk_gives_the_gradients(name):
    """The kernel's walk over the plain ordering gives the plain HT
    pool's gradients and, where wv is a 0/1 mask, those of JAX's f32
    reference `ht_pool_ref` on the same index streams."""
    pix, di, wv, HW, D = _case(name, seed=1)
    B, N, Zh, Nq = pix.shape
    C = 5
    rng = np.random.default_rng(2)
    dep = rng.random((B, N, HW, D), dtype=np.float32)
    ctx = rng.standard_normal((B, N, HW, C), dtype=np.float32)
    dout = rng.standard_normal((B, Nq, C), dtype=np.float32)
    t = [torch.from_numpy(x) for x in (dep, ctx, pix, di, wv)]
    ends, order = thp.ht_pool_order_plain(t[2], t[3], t[4], HW, D)
    got = _walk(dep, ctx, wv, dout, ends.numpy(), order.numpy(), Zh, Nq)
    t[0].requires_grad_()
    t[1].requires_grad_()
    out = thp.ht_pool_points_plain(*t)
    wants = [[g.numpy() for g in torch.autograd.grad(
        out, t[:2], torch.from_numpy(dout))]]
    if set(np.unique(wv)) <= {0.0, 1.0}:
        # uvd that rounds to these pixels (h x w = 4 x 5) and bins
        h, w = 4, 5
        uvd = jnp.asarray(np.stack([pix % w / w, pix // w / h, di / D],
                                   -1).astype(np.float32))
        valid = jnp.asarray(wv != 0)
        jpix, jdi, _ = jhp._indices((B, N, h, w, D), uvd, valid)
        np.testing.assert_array_equal(np.asarray(jpix), pix)
        np.testing.assert_array_equal(np.asarray(jdi), di)

        def loss(dep, ctx):
            out = jhp.ht_pool_ref(dep.reshape(B, N, h, w, D),
                                  ctx.reshape(B, N, h, w, C), uvd, valid)
            return jnp.sum(out * dout)
        wants.append([np.asarray(g).reshape(x.shape) for g, x in zip(
            jax.grad(loss, argnums=(0, 1))(jnp.asarray(dep),
                                           jnp.asarray(ctx)), (dep, ctx))])
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))
