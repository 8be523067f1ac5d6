"""The work of the port's hand-written kernels K1-K4 on one call's
inputs, and the H100's peaks: a frozen copy of the port's `ops/work.py`
(its K1-K4 formulas; K5, which only training runs, is not copied) that
later changes to the program leave alone. Bytes count each input read once and
each output written once; operations are counted where they depend on
the data from what this call's data needs. Plain PyTorch."""
from __future__ import annotations

import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_FP32_FLOP_PER_S = 67e12    # fp32 outside the tensor cores
H100_BF16_FLOP_PER_S = 989e12   # bf16 tensor cores, dense


def bound_s(w: dict) -> float:
    """The least time an H100 could take to move w["bytes"] and do
    w["flops"] fp32 operations, in seconds."""
    return max(w["bytes"] / H100_BYTES_PER_S, w["flops"] / H100_FP32_FLOP_PER_S)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def k1_taps(depths, az, bz, a2, b2, H, W) -> int:
    """K1's in-image bilinear taps for these coordinates (the plain
    version's coordinate formula)."""
    BN = az.shape[0] * az.shape[1]
    dv = depths[:, None, None]
    den = dv * az.reshape(1, BN, -1) + bz.reshape(1, BN, 1)
    front = den >= 1e-3
    safe = torch.where(front, den, torch.ones_like(den))
    px = (dv * a2[..., 0].reshape(1, BN, -1) + b2[..., 0].reshape(1, BN, 1)) / safe
    py = (dv * a2[..., 1].reshape(1, BN, -1) + b2[..., 1].reshape(1, BN, 1)) / safe
    taps = 0
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = px.floor() + dx, py.floor() + dy
            taps += int((front & (xi >= 0) & (xi <= W - 1) & (yi >= 0)
                         & (yi <= H - 1)).sum())
    return taps


def cost_volume_work(curr, prev, depths, az, bz, a2, b2, out) -> dict:
    """K1: 2 operations per channel per in-image tap and 3 per channel
    per sample (sub, abs, add); the features (prev as the bf16 the
    function reads), depths, coefficients and volume."""
    Hc, Wc, C = curr.shape[2:]
    taps = k1_taps(depths, az, bz, a2, b2, Hc, Wc)
    coef_bytes = (az.numel() + a2.numel() + bz.numel() + b2.numel()) * 4
    return dict(bytes=nbytes(curr, depths, out) + prev.numel() * 2
                + coef_bytes,
                flops=C * (2 * taps + 3 * out.numel()))


def bev_pool_work(w, pix, cell, feat, out, cells) -> dict:
    """K2's forward: a product and a sum per channel per point in the
    grid; the streams, the features and the pooled grid."""
    n_valid = int((cell < cells).sum())
    return dict(bytes=nbytes(w, pix, cell, feat, out),
                flops=2 * feat.shape[-1] * n_valid)


def ht_pool_work(dep, ctx, pix, di, wv, out) -> dict:
    """K3's forward: 2 C + 1 operations per valid point."""
    n_valid = int(wv.sum())
    return dict(bytes=nbytes(dep, ctx, pix, di, wv, out),
                flops=n_valid * (2 * ctx.shape[-1] + 1))


def point_sample_work(maps, px, py, out) -> dict:
    """K4's forward: 4 products and 3 sums per output value, ~12
    operations per point for its tap weights."""
    return dict(bytes=nbytes(maps, px, py, out),
                flops=7 * out.numel() + 12 * px.numel())
