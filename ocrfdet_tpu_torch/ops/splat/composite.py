"""Per-tile Gaussian alpha compositing, kernel K5 (counterpart of
ocrfdet_tpu/ops/splat/render_pallas.py::composite_tiles).

The tile selection (render_tiled.py) hands over, for every 16 x 16 tile
of every sample, its M nearest Gaussians front to back as one tensor
attrs [NT, M, 11] (NT = samples x tiles; dead slots have op == 0) with
the attributes `STREAMS` in its last axis. `composite_tiles` returns
(rgb [NT, P, 3], med [NT, P], logt [NT, P]), P = tile_h * tile_w: the
colour, the median depth (the depth of the Gaussian at which T first
drops below 0.5, 15.0 if none) and the log transmittance; the caller
adds the background. Its backward gives the gradient of every
attribute but rad (zero), with the median's gradient on the crossing
Gaussian's depth: the forward also finds each pixel's crossing slot
(`cross` [NT, P] int32, the slot at which T first drops below 0.5, -1
if none), which the backward reads.

`composite_tiles` calls the custom op `ocrfdet::composite_forward`,
whose registered backward is the op `ocrfdet::composite_backward`. For
CUDA tensors they run kernel K5 (`csrc/composite_tiles.cu`: `KERNEL`
forward, `BWD_KERNEL` backward, one launch each over all the samples'
tiles); for CPU tensors its plain version, whose forward and backward
mirror the Pallas kernels' chunk-by-chunk computation (render_pallas.py
`_mirror_fwd` / `_mirror_bwd`, chunks of `CHUNK` Gaussians) with tensor
operations, the backward written out (the suffix trick) rather than
left to autograd, which would keep [NT, CHUNK, P] temporaries of every
chunk. `composite_tiles_plain` is that plain version as an autograd
function on any device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ... import kernels

STREAMS = ("mx", "my", "ca", "cb", "cc", "rad", "dep", "op",
           "cr", "cg", "cb_col")
CHUNK = 128
ALPHA_EPS = 1.0 / 255.0
MEDIAN_DEPTH_DEFAULT = 15.0
MED_BIG = 1e30
TILE_PIXELS = 256          # the kernel runs one thread per pixel

KERNEL = kernels.Kernel(
    name="composite_tiles", source="composite_tiles.cu",
    symbol="composite_tiles_forward",
    argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="ocrfdet_tpu/ops/splat/render_pallas.py:341")  # composite_tiles
BWD_KERNEL = kernels.Kernel(
    name="composite_tiles_bwd", source="composite_tiles.cu",
    symbol="composite_tiles_backward",
    argtypes=[ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="ocrfdet_tpu/ops/splat/render_pallas.py:150")  # _bwd_kernel


# ---------------------------------------------------------------- plain
def _pixel_coords(NT, T, n_tx, tile_h, tile_w, device):
    """Pixel centres of every tile: px, py [NT, P] f32."""
    t = torch.arange(NT, device=device) % T
    p = torch.arange(tile_h * tile_w, device=device)
    px = (t % n_tx)[:, None] * tile_w + p[None, :] % tile_w
    py = (t // n_tx)[:, None] * tile_h + p[None, :] // tile_w
    return px.float(), py.float()


def _chunk_quantities(c, px, py):
    """Per-(Gaussian, pixel) quantities of one chunk c [NT, K, 11]."""
    mx, my, ca, cb, cc, rad, dep, op = (c[..., i, None] for i in range(8))
    dx = px[:, None, :] - mx                        # [NT, K, P]
    dy = py[:, None, :] - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    e = torch.exp(torch.clamp(power, max=0.0))
    raw = op * e
    alpha = torch.clamp(raw, max=0.99)
    keep = ((dx.abs() <= rad) & (dy.abs() <= rad) & (power <= 0.0)
            & (alpha >= ALPHA_EPS))
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    log1m = torch.log1p(-alpha)
    cum_in = torch.cumsum(log1m, dim=1)
    return dict(dx=dx, dy=dy, power=power, e=e, raw=raw, keep=keep,
                alpha=alpha, log1m=log1m, cum_in=cum_in, ca=ca, cb=cb, cc=cc,
                op=op, dep=dep)


def composite_forward_plain(attrs, n_tiles: int, n_tx: int, tile_h: int,
                            tile_w: int):
    """Plain version of K5's forward (the Pallas `_mirror_fwd`): rgb, med,
    logt and the crossing slot `cross` (the first slot whose kept
    Gaussian leaves T below 0.5, -1 if none)."""
    NT, M, _ = attrs.shape
    px, py = _pixel_coords(NT, n_tiles, n_tx, tile_h, tile_w, attrs.device)
    z = torch.zeros_like(px)
    rgb = torch.zeros((NT, px.shape[1], 3), device=attrs.device)
    logt, found = z.clone(), z.clone()
    med = torch.full_like(px, MEDIAN_DEPTH_DEFAULT)
    cross = torch.full(px.shape, -1, dtype=torch.int32, device=px.device)
    for k0 in range(0, M, CHUNK):
        c = attrs[:, k0:k0 + CHUNK]
        q = _chunk_quantities(c, px, py)
        alpha, cum_in = q["alpha"], q["cum_in"]
        t_here = torch.exp(logt[:, None, :] + (cum_in - q["log1m"]))
        w = alpha * t_here
        rgb = rgb + torch.einsum("tkp,tkc->tpc", w, c[..., 8:11])
        t_after = torch.exp(logt[:, None, :] + cum_in)
        crossed = (t_after < 0.5) & (alpha > 0.0)
        med_c = torch.where(crossed, q["dep"], torch.full_like(
            t_after, MED_BIG)).amin(dim=1)
        fresh = (found == 0.0) & (med_c < MED_BIG)
        med = torch.where(fresh, med_c, med)
        # argmax gives the first of the equal maxima: the first crossing
        first = crossed.to(torch.int32).argmax(dim=1).to(torch.int32) + k0
        cross = torch.where(fresh, first, cross)
        found = torch.maximum(found, crossed.any(dim=1).float())
        logt = logt + cum_in[:, -1]
    return rgb, med, logt, cross


def composite_backward_plain(attrs, tot_rgb, g_rgb, g_logt, g_med, cross,
                             n_tiles: int, n_tx: int, tile_h: int,
                             tile_w: int):
    """Plain version of K5's backward (the Pallas `_mirror_bwd`, the
    suffix trick): dattrs [NT, M, 11], rad's column 0. The median's
    gradient goes to each pixel's crossing slot `cross` (from the
    forward)."""
    NT, M, _ = attrs.shape
    px, py = _pixel_coords(NT, n_tiles, n_tx, tile_h, tile_w, attrs.device)
    gr, gg, gb = g_rgb[..., 0], g_rgb[..., 1], g_rgb[..., 2]
    gt = (gr * tot_rgb[..., 0] + gg * tot_rgb[..., 1]
          + gb * tot_rgb[..., 2])
    logt = torch.zeros_like(px)
    gpre = torch.zeros_like(px)
    out = []
    for k0 in range(0, M, CHUNK):
        c = attrs[:, k0:k0 + CHUNK]
        q = _chunk_quantities(c, px, py)
        alpha, cum_in = q["alpha"], q["cum_in"]
        t_here = torch.exp(logt[:, None, :] + (cum_in - q["log1m"]))
        w = alpha * t_here
        cr, cg, cbc = (c[..., i, None] for i in (8, 9, 10))
        gc = gr[:, None] * cr + gg[:, None] * cg + gb[:, None] * cbc
        gpre_i = gpre[:, None] + torch.cumsum(w * gc, dim=1)
        suffix = gt[:, None] - gpre_i
        one_m = 1.0 - alpha
        dalpha = gc * t_here - suffix / one_m - g_logt[:, None] / one_m
        live = (q["keep"] & (q["raw"] < 0.99)).float()
        dalpha = dalpha * live
        dpow = dalpha * q["op"] * q["e"] * (q["power"] < 0.0).float()
        dx, dy = q["dx"], q["dy"]
        slots = torch.arange(k0, k0 + c.shape[1], device=attrs.device)
        sel = (slots[None, :, None] == cross[:, None, :]).float()
        ca, cb, cc = q["ca"], q["cb"], q["cc"]
        grads = [
            (dpow * (ca * dx + cb * dy)).sum(2),          # mx
            (dpow * (cc * dy + cb * dx)).sum(2),          # my
            (dpow * (-0.5 * dx * dx)).sum(2),             # ca
            (dpow * (-dx * dy)).sum(2),                   # cb
            (dpow * (-0.5 * dy * dy)).sum(2),             # cc
            torch.zeros_like(c[..., 5]),                  # rad
            (g_med[:, None] * sel).sum(2),                # dep
            (dalpha * q["e"]).sum(2),                     # op
            (w * gr[:, None]).sum(2),                     # cr
            (w * gg[:, None]).sum(2),                     # cg
            (w * gb[:, None]).sum(2),                     # cb_col
        ]
        out.append(torch.stack(grads, dim=-1))
        gpre = gpre_i[:, -1]
        logt = logt + cum_in[:, -1]
    return torch.cat(out, dim=1)


def _cotangents(rgb, g_rgb, g_med, g_logt):
    """Missing cotangents as zeros, all f32 and contiguous."""
    def z(g, like):
        g = torch.zeros_like(like) if g is None else g
        return g.float().contiguous()
    return z(g_rgb, rgb), z(g_med, rgb[..., 0]), z(g_logt, rgb[..., 0])


class _CompositePlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, n_tiles, n_tx, tile_h, tile_w):
        rgb, med, logt, cross = composite_forward_plain(
            attrs, n_tiles, n_tx, tile_h, tile_w)
        ctx.save_for_backward(attrs, rgb, cross)
        ctx.dims = (n_tiles, n_tx, tile_h, tile_w)
        return rgb, med, logt

    @staticmethod
    def backward(ctx, g_rgb, g_med, g_logt):
        attrs, rgb, cross = ctx.saved_tensors
        g_rgb, g_med, g_logt = _cotangents(rgb, g_rgb, g_med, g_logt)
        d = composite_backward_plain(attrs, rgb, g_rgb, g_logt, g_med,
                                     cross, *ctx.dims)
        return d, None, None, None, None


def composite_tiles_plain(attrs, n_tiles: int, n_tx: int, tile_h: int,
                          tile_w: int):
    """The plain version of `composite_tiles` (forward and backward), on
    any device."""
    return _CompositePlain.apply(attrs, n_tiles, n_tx, tile_h, tile_w)


# --------------------------------------------------------------- kernel
def composite_forward(attrs, n_tiles: int, n_tx: int, tile_w: int):
    """K5's forward kernel on a CUDA tensor attrs [NT, M, 11] f32: rgb,
    med, logt and the crossing slot (int32)."""
    NT, M, _ = attrs.shape
    rgb = torch.empty((NT, TILE_PIXELS, 3), dtype=torch.float32,
                      device=attrs.device)
    med = torch.empty((NT, TILE_PIXELS), dtype=torch.float32,
                      device=attrs.device)
    logt = torch.empty_like(med)
    cross = torch.empty(med.shape, dtype=torch.int32, device=attrs.device)
    KERNEL.launch(kernels.ptr(attrs), kernels.ptr(rgb), kernels.ptr(med),
                  kernels.ptr(logt), kernels.ptr(cross), NT, n_tiles, M,
                  n_tx, tile_w, kernels.stream_of(attrs))
    return rgb, med, logt, cross


def composite_backward(attrs, tot_rgb, g_rgb, g_logt, g_med, cross,
                       n_tiles: int, n_tx: int, tile_w: int):
    """K5's backward kernel on CUDA tensors: dattrs [NT, M, 11]."""
    dattrs = torch.empty_like(attrs)
    NT, M, _ = attrs.shape
    BWD_KERNEL.launch(kernels.ptr(attrs), kernels.ptr(tot_rgb),
                      kernels.ptr(g_rgb), kernels.ptr(g_logt),
                      kernels.ptr(g_med), kernels.ptr(cross),
                      kernels.ptr(dattrs), NT, n_tiles, M, n_tx, tile_w,
                      kernels.stream_of(attrs))
    return dattrs


def _check_attrs(attrs, n_tiles: int, tile_h: int, tile_w: int):
    """Raise unless K5's kernels can take this CUDA tensor."""
    if attrs.dim() != 3 or attrs.shape[-1] != len(STREAMS):
        raise ValueError(f"composite_tiles: attrs [NT, M, 11] expected, "
                         f"got {tuple(attrs.shape)}")
    if attrs.dtype != torch.float32:
        raise TypeError(f"composite_tiles: attrs must be torch.float32, "
                        f"got {attrs.dtype}")
    if not attrs.is_contiguous():
        raise ValueError("composite_tiles: attrs is not contiguous")
    if tile_h * tile_w != TILE_PIXELS:
        raise ValueError(f"composite_tiles: tile {tile_h}x{tile_w}, the "
                         f"kernel takes {TILE_PIXELS} pixels")
    if attrs.shape[0] % n_tiles:
        raise ValueError(f"composite_tiles: {attrs.shape[0]} tiles is not "
                         f"a multiple of {n_tiles}")


# ------------------------------------------------ the custom ops of K5
@torch.library.custom_op(f"{kernels.OPS_NAMESPACE}::composite_forward",
                         mutates_args=(), device_types="cpu")
def _composite_forward_op(attrs: torch.Tensor, n_tiles: int, n_tx: int,
                          tile_h: int, tile_w: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    return composite_forward_plain(attrs, n_tiles, n_tx, tile_h, tile_w)


@_composite_forward_op.register_kernel("cuda")
def _(attrs, n_tiles, n_tx, tile_h, tile_w):
    _check_attrs(attrs, n_tiles, tile_h, tile_w)
    return composite_forward(attrs, n_tiles, n_tx, tile_w)


@_composite_forward_op.register_fake
def _(attrs, n_tiles, n_tx, tile_h, tile_w):
    NT, P = attrs.shape[0], tile_h * tile_w
    med = attrs.new_empty((NT, P))
    return (attrs.new_empty((NT, P, 3)), med, torch.empty_like(med),
            attrs.new_empty((NT, P), dtype=torch.int32))


@torch.library.custom_op(f"{kernels.OPS_NAMESPACE}::composite_backward",
                         mutates_args=(), device_types="cpu")
def _composite_backward_op(attrs: torch.Tensor, tot_rgb: torch.Tensor,
                           g_rgb: torch.Tensor, g_logt: torch.Tensor,
                           g_med: torch.Tensor, cross: torch.Tensor,
                           n_tiles: int, n_tx: int, tile_h: int,
                           tile_w: int) -> torch.Tensor:
    return composite_backward_plain(attrs, tot_rgb, g_rgb, g_logt, g_med,
                                    cross, n_tiles, n_tx, tile_h, tile_w)


@_composite_backward_op.register_kernel("cuda")
def _(attrs, tot_rgb, g_rgb, g_logt, g_med, cross, n_tiles, n_tx, tile_h,
      tile_w):
    return composite_backward(attrs, tot_rgb, g_rgb, g_logt, g_med, cross,
                              n_tiles, n_tx, tile_w)


@_composite_backward_op.register_fake
def _(attrs, tot_rgb, g_rgb, g_logt, g_med, cross, n_tiles, n_tx, tile_h,
      tile_w):
    return torch.empty_like(attrs)


def _composite_setup(ctx, inputs, output):
    attrs, n_tiles, n_tx, tile_h, tile_w = inputs
    rgb, _, _, cross = output
    ctx.save_for_backward(attrs, rgb, cross)
    ctx.dims = (n_tiles, n_tx, tile_h, tile_w)


def _composite_grad(ctx, g_rgb, g_med, g_logt, g_cross):
    attrs, rgb, cross = ctx.saved_tensors
    g_rgb, g_med, g_logt = _cotangents(rgb, g_rgb, g_med, g_logt)
    d = _composite_backward_op(attrs, rgb, g_rgb, g_logt, g_med, cross,
                               *ctx.dims)
    return d, None, None, None, None


_composite_forward_op.register_autograd(_composite_grad,
                                        setup_context=_composite_setup)


def composite_tiles(attrs, n_tiles: int, n_tx: int, tile_h: int,
                    tile_w: int):
    """K5 (`ocrfdet::composite_forward`): attrs [NT, M, 11] f32 (NT a
    multiple of n_tiles, the tiles of one sample in raster order, n_tx
    per row). Returns (rgb [NT,P,3], med [NT,P], logt [NT,P]),
    differentiable in attrs."""
    rgb, med, logt, _ = _composite_forward_op(
        attrs, n_tiles, n_tx, tile_h, tile_w)
    return rgb, med, logt
