"""Row blocks of the BEV grid over the `space` axis (counterpart of
ocrfdet_tpu/parallel/halo.py). The port is NCHW: rows are dim 2.

After the view transformer each rank of a space group keeps its block of
the BEV grid's rows through the pre-process, the BEV encoder and the
CenterHead (`models/detector.py`), and renders its band of the image's
rows in the splat render (`models/ocrf/view_transformer_ocrf.py`).
Why each piece equals the full grid's rows:

  * `halo_exchange_rows` gives a block its neighbours' boundary rows;
    the global top and bottom edges receive zeros, which is the zero
    padding of a pad-1 conv there. A 3x3 stride-1 conv on [halo, block,
    halo] with no row padding therefore gives the full conv's rows.
  * A 3x3 stride-2 conv with pad 1 on an even grid reads input rows
    2o-1 .. 2o+1 for output row o: at an even row offset a (1, 0) halo
    reproduces them (`conv_row_halo`).
  * BatchNorm's statistics are the sums over the exact local block
    (the conv consumed the halo rows), all-reduced over the axis
    (`models/norm.py`): the full grid's statistics.
  * align-corners bilinear upsampling along rows is a banded matrix of
    radius 1: each block applies its band of the full matrix to its
    halo-extended block (`resize_rows_blocked`).

`halo_exchange_rows` is built from an all-gather of every rank's two
boundary strips (no point-to-point sends), and its backward is the
forward's transpose: each halo row's cotangent goes back to the rank
that owns the row and is added into it (collectives.py has the gradient
convention).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .collectives import Axis, all_gather_dim

# A halo spec: the space axis, or None where rows are not sharded.
HaloSpec = Optional[Axis]


def _strips(x: torch.Tensor, first: int, last: int, dim: int):
    """x's first `first` and last `last` rows along dim, concatenated."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, first), x.narrow(dim, n - last, last)],
                     dim)


def _neighbours(x: torch.Tensor, axis: Axis, first: int, last: int,
                dim: int):
    """All-gather every rank's (first, last) strips of x; returns (the
    previous rank's, the next rank's), each None at the grid's edge."""
    parts = all_gather_dim(_strips(x, first, last, dim).unsqueeze(0), axis,
                           0)
    s = axis.index
    prev = parts[s - 1] if s > 0 else None
    nxt = parts[s + 1] if s + 1 < axis.size else None
    return prev, nxt


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, up, down, dim):
        ctx.axis, ctx.up, ctx.down, ctx.dim = axis, up, down, dim
        # a rank sends its first `down` rows (the previous rank's bottom
        # halo) and its last `up` rows (the next rank's top halo)
        prev, nxt = _neighbours(x, axis, down, up, dim)
        shape = list(x.shape)
        parts = []
        if up:
            shape[dim] = up
            parts.append(prev.narrow(dim, down, up) if prev is not None
                         else x.new_zeros(shape))
        parts.append(x)
        if down:
            shape[dim] = down
            parts.append(nxt.narrow(dim, 0, down) if nxt is not None
                         else x.new_zeros(shape))
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        axis, up, down, dim = ctx.axis, ctx.up, ctx.down, ctx.dim
        n = g.shape[dim] - up - down
        # the cotangents of this rank's halo rows, top then bottom, go
        # back to their owners
        prev, nxt = _neighbours(
            torch.cat([g.narrow(dim, 0, up), g.narrow(dim, up + n, down)],
                      dim), axis, up, down, dim)
        dx = g.narrow(dim, up, n).clone()
        if nxt is not None and up:     # the next rank's top halo = my last
            dx.narrow(dim, n - up, up).add_(nxt.narrow(dim, 0, up))
        if prev is not None and down:  # the previous rank's bottom = my first
            dx.narrow(dim, 0, down).add_(prev.narrow(dim, up, down))
        return dx, None, None, None, None


def halo_exchange_rows(x: torch.Tensor, axis: Axis, up: int = 1,
                       down: int = 1, dim: int = 2) -> torch.Tensor:
    """x's row block extended by `up` rows of the previous rank and `down`
    rows of the next (zeros at the grid's edges): [.., up + Yl + down, ..]
    along `dim`."""
    return _HaloRows.apply(x, axis, up, down, dim)


def conv_row_halo(kernel: int, stride: int) -> Tuple[int, int]:
    """(up, down) halo rows a row-blocked conv needs so that no row
    padding reproduces the full grid's pad-(k // 2) conv: (1, 1) for
    3x3 stride 1, (1, 0) for 3x3 stride 2 at even offsets, none for
    1x1."""
    if kernel == 1:
        return 0, 0
    if kernel != 3 or stride not in (1, 2):
        raise ValueError(f"row halo of a {kernel}x{kernel} stride-{stride} "
                         f"conv")
    return (1, 1) if stride == 1 else (1, 0)


def resize_rows_matrix(n_out: int, n_in: int) -> np.ndarray:
    """The align-corners bilinear interpolation matrix W [n_out, n_in]
    along one axis (F.interpolate(align_corners=True)'s weights)."""
    if n_out == 1 or n_in == 1:
        return np.full((n_out, n_in), 1.0 / n_in, np.float32)
    pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(pos).astype(int), 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = (pos - lo).astype(np.float32)
    W = np.zeros((n_out, n_in), np.float32)
    W[np.arange(n_out), lo] += 1.0 - w_hi
    W[np.arange(n_out), hi] += w_hi
    return W


def _resize_product(equation: str, W: torch.Tensor, x: torch.Tensor
                    ) -> torch.Tensor:
    """A blocked resize's product with its static matrix, in fp32 outside
    autocast, in the dtype F.interpolate's bilinear gives: fp32 under
    CUDA autocast (whose fp32 list holds the upsampling), else x's."""
    with torch.autocast(x.device.type, enabled=False):
        y = torch.einsum(equation, W, x.float())
    if x.device.type == "cuda" and torch.is_autocast_enabled("cuda"):
        return y
    return y.to(x.dtype)


def resize_cols(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """align-corners bilinear resize of an NCHW tensor along its columns
    as a product with the static matrix (`_resize_product`)."""
    W = torch.from_numpy(resize_rows_matrix(n_out, x.shape[3])).to(x.device)
    return _resize_product("ow,bchw->bcho", W, x)


def resize_rows_blocked(x: torch.Tensor, n_out_global: int,
                        axis: Axis) -> torch.Tensor:
    """This rank's [B, C, n_out_global / S, W] block of the align-corners
    row upsampling of the row-blocked x [B, C, Yl_in, W] (global rows
    S * Yl_in). Upsampling only: a shrinking resize would read rows
    outside the 1-row halo."""
    S, Yl_in = axis.size, x.shape[2]
    if n_out_global % S:
        raise ValueError(f"{n_out_global} rows over {S} ranks")
    if n_out_global < Yl_in * S:
        raise ValueError(f"resize_rows_blocked is upsampling only: "
                         f"{Yl_in * S} -> {n_out_global} rows")
    Yl_out = n_out_global // S
    W = resize_rows_matrix(n_out_global, Yl_in * S)
    # column j of the padded matrix is input row j - 1: the halo-extended
    # block's row coordinates
    Wp = np.pad(W, ((0, 0), (1, 1)))
    s = axis.index
    band = torch.from_numpy(np.ascontiguousarray(
        Wp[s * Yl_out:(s + 1) * Yl_out, s * Yl_in:s * Yl_in + Yl_in + 2])
    ).to(x.device)
    return _resize_product("oi,bciw->bcow", band,
                           halo_exchange_rows(x, axis, 1, 1))


def slice_rows(t: torch.Tensor, axis: Axis, dim: int = 2) -> torch.Tensor:
    """This rank's row block of a tensor every rank holds whole."""
    Y, S = t.shape[dim], axis.size
    if Y % S:
        raise ValueError(f"{Y} rows over {S} ranks")
    return t.narrow(dim, axis.index * (Y // S), Y // S)
