"""The work of the hand-written kernels K1-K5 on one call's inputs: the
bytes the function must move (each input read once, each output written
once) and the operations it does, counted where they depend on the data
from what this call's data needs. `chip_smoke.py` divides them by the
H100's rates for each kernel's bound; `tools/get_flops.py` adds them to
the model's count, which `FlopCounterMode` takes from matrix products
and convolutions and which never sees the kernels. Plain PyTorch: runs
on any device.
"""
from __future__ import annotations

import torch

from .splat import composite as ct

H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_FP32_FLOP_PER_S = 67e12    # fp32 outside the tensor cores


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time an H100 could take
    to move `nbytes` and do `flops` fp32 operations."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def k1_row_loads(depths, az, bz, a2, b2, H, W):
    """(in-image taps, row loads) that K1's design implies for these
    coordinates, worked out with the plain version's coordinate formula:
    a walk loads a tap's row unless the plane before had the same pixel
    in the image. (The kernel's load-counting build measures the loads
    themselves: `ops/cost_volume.py::cost_volume_row_loads`.)"""
    BN = az.shape[0] * az.shape[1]
    dv = depths[:, None, None]
    den = dv * az.reshape(1, BN, -1) + bz.reshape(1, BN, 1)
    front = den >= 1e-3
    safe = torch.where(front, den, torch.ones_like(den))
    px = (dv * a2[..., 0].reshape(1, BN, -1) + b2[..., 0].reshape(1, BN, 1)) / safe
    py = (dv * a2[..., 1].reshape(1, BN, -1) + b2[..., 1].reshape(1, BN, 1)) / safe
    ids = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = px.floor() + dx, py.floor() + dy
            inb = front & (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            ids.append(torch.where(inb, yi * W + xi, torch.full_like(xi, -1)))
    ids = torch.stack(ids, 1)                         # [D, 4, BN, HW]
    inb = ids >= 0
    held = torch.zeros_like(inb)     # (an out-of-image id, -1, never matches)
    held[1:] = (ids[1:, :, None] == ids[:-1, None]).any(2)
    return int(inb.sum()), int((inb & ~held).sum())


def cost_volume_work(curr, prev, depths, az, bz, a2, b2, out) -> dict:
    """K1 (`cost_volume`): 2 operations per channel per in-image tap and
    3 per channel per sample (sub, abs, add); the features, depths,
    coefficients and volume. Also the taps and the design's row loads."""
    Hc, Wc, C = curr.shape[2:]
    taps, loads = k1_row_loads(depths, az, bz, a2, b2, Hc, Wc)
    flops = C * (2 * taps + 3 * out.numel())
    coef_bytes = (az.numel() + a2.numel() + bz.numel() + b2.numel()) * 4
    return dict(bytes=nbytes(curr, prev, depths, out) + coef_bytes,
                flops=flops, taps=taps, row_loads=loads)


def bev_pool_work(w, pix, cell, feat, out, cells) -> dict:
    """K2's forward: a product and a sum per channel per point in the
    grid; the streams, the features and the pooled grid."""
    n_valid = int((cell < cells).sum())
    return dict(bytes=nbytes(w, pix, cell, feat, out),
                flops=2 * feat.shape[-1] * n_valid, points=n_valid)


def bev_pool_backward_work(w, cell, feat, g, dw, dfeat, cells) -> dict:
    """K2's backward on the LSS layout (pix is never read): dfeat's and
    dw's product and sum per channel per point in the grid."""
    n_valid = int((cell < cells).sum())
    return dict(bytes=nbytes(w, cell, feat, g, dw, dfeat),
                flops=4 * feat.shape[-1] * n_valid, points=n_valid)


def ht_pool_work(dep, ctx, pix, di, wv, out) -> dict:
    """K3's forward (`ht_pool_points`' arguments): 2 C + 1 operations per
    valid (pillar, camera, height) point."""
    n_valid = int(wv.sum())
    return dict(bytes=nbytes(dep, ctx, pix, di, wv, out),
                flops=n_valid * (2 * ctx.shape[-1] + 1), points=n_valid)


def ht_pool_backward_work(dep, ctx, pix, di, wv, dout, ddep, dctx) -> dict:
    """K3's backward: 4 C + 2 operations per valid point."""
    n_valid = int(wv.sum())
    return dict(bytes=nbytes(dep, ctx, pix, di, wv, dout, ddep, dctx),
                flops=n_valid * (4 * ctx.shape[-1] + 2), points=n_valid)


def point_sample_work(maps, px, py, out) -> dict:
    """K4's forward: 4 products and 3 sums per output value, ~12
    operations per point for its tap weights."""
    return dict(bytes=nbytes(maps, px, py, out),
                flops=7 * out.numel() + 12 * px.numel())


def k4_bwd_bytes(px, py, dout, H, W):
    """The bytes K4's backward must move: px and py, the dout rows of
    the points with a tap in the image (in the 32-byte sectors that hold
    them) and one write of dmap [BN,H,W,C]; and those points' count."""
    fx, fy = torch.floor(px), torch.floor(py)
    inside = ((fx >= -1) & (fx <= W - 1) & (fy >= -1)
              & (fy <= H - 1)).reshape(-1)
    row = dout.shape[-1] * dout.element_size()
    first = torch.nonzero(inside).reshape(-1) * row
    sectors = torch.unique(torch.cat([first // 32, (first + row - 1) // 32]))
    dmap = px.shape[0] * H * W * dout.shape[-1] * 4
    return (nbytes(px, py) + 32 * sectors.numel() + dmap,
            int(inside.sum()))


def point_sample_backward_work(px, py, dout, H, W) -> dict:
    """K4's backward (`k4_bwd_bytes`): ~20 operations a point for its
    base tap and tiles, ~12 for its tap weights and 2 C a contribution
    (a product and a sum) for each point with a tap in the image."""
    moved, n_in = k4_bwd_bytes(px, py, dout, H, W)
    C = dout.shape[-1]
    return dict(bytes=moved, flops=20 * px.numel() + n_in * (12 + 8 * C),
                points=n_in)


def point_sample_order_work(px, py, keys: int) -> dict:
    """K4's backward binning: read px and py, write each key once."""
    return dict(bytes=nbytes(px, py) + 8 * keys, flops=20 * px.numel())


def composite_work(attrs, T, n_tx) -> dict:
    """K5's work on its input, worked out with the plain version's
    quantities: live slots, (pixel, live Gaussian) pairs inside the
    Gaussian's 3-sigma square and pairs that pass the keep test."""
    NT = attrs.shape[0]
    px, py = ct._pixel_coords(NT, T, n_tx, 16, 16, attrs.device)
    square = kept = 0
    for k0 in range(0, attrs.shape[1], ct.CHUNK):
        c = attrs[:, k0:k0 + ct.CHUNK]
        q = ct._chunk_quantities(c, px, py)
        live = (c[..., 7] != 0)[..., None]
        rad = c[..., 5, None]
        near = (q["dx"].abs() <= rad) & (q["dy"].abs() <= rad) & live
        square += int(near.sum())
        kept += int(q["keep"].sum())
    return dict(live=int((attrs[..., 7] != 0).sum()), square=square,
                kept=kept)


def composite_forward_work(attrs, rgb, med, logt, counts) -> dict:
    """K5's forward (`counts` from `composite_work`): ~15 operations per
    evaluated (pixel, live Gaussian) pair (offsets, power, exp, alpha,
    keep) and ~8 more per kept pair (weight, RGB, T's running product,
    crossing and median)."""
    pairs = counts["live"] * ct.TILE_PIXELS
    return dict(bytes=nbytes(attrs, rgb, med, logt),
                flops=15 * pairs + 8 * counts["kept"])


def composite_backward_work(attrs, tot_rgb, g_rgb, g_logt, g_med, dattrs,
                            counts) -> dict:
    """K5's backward: ~15 operations per evaluated pair and ~45 per kept
    pair (the suffix trick and ten chain-rule terms, their sums)."""
    pairs = counts["live"] * ct.TILE_PIXELS
    return dict(bytes=nbytes(attrs, tot_rgb, g_rgb, g_logt, g_med, dattrs),
                flops=15 * pairs + 45 * counts["kept"])
