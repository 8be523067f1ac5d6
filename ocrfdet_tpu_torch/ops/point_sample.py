"""Bilinear sampling of full-resolution per-camera maps at projected
voxel points (counterpart of ocrfdet_tpu/ops/point_sample.py).

    val[bn, p, c] = sum over the 4 taps (u, v) around (px, py) of
                    relu(1-|px-u|) * relu(1-|py-v|) * map[bn, v, u, c]

in pixel coordinates (no half-pixel shift), taps outside the image
weighing zero: for px in (-1, 0) the tap u = 0 weighs 1-|px|. This is
`bilinear_sample_block` (ops/grid_sample.py), the JAX `point_sample_ref`.
`point_sample` is the wrapper of kernel K4 (`csrc/point_sample.cu`, the
counterpart of the Pallas `_point_sample_mm` forward): it calls the
custom op `ocrfdet::point_sample`, whose CUDA implementation launches
the kernel and whose CPU implementation is `point_sample_points_plain`.
The kernel is specialised on C (1-4); for C = 4 with 16-byte aligned
maps and output it reads each tap as one 16-byte load (the launcher
picks the form; both give the same bits). Both compute in fp32. The
registered backward (the maps' gradient, for every channel; px and py
get none, as in the Pallas VJP) is the op `ocrfdet::point_sample_backward`.
On CUDA it bins the points with a tap in the image by 16 x 16 output
tile (`point_sample_order`, `ORDER_KERNEL`, inside the op; its plain
version is `point_sample_order_plain`), then launches K4's backward kernel
(`BWD_KERNEL`), one block a tile, which writes every value of dmap once,
each texel's sum in a fixed order: its points by base tap (v-1, u-1),
(v-1, u), (v, u-1), (v, u), then by point index. On the CPU it is
`point_sample_backward_walk_plain`, which adds in that order and gives
the kernel's bits.
"""
from __future__ import annotations

import ctypes
import torch

from .. import kernels

KERNEL = kernels.Kernel(
    name="point_sample", source="point_sample.cu",
    symbol="point_sample_forward",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_int64]
    + [ctypes.c_void_p],
    replaces="ocrfdet_tpu/ops/point_sample.py:119")   # _point_sample_mm
BWD_KERNEL = kernels.Kernel(
    name="point_sample_bwd", source="point_sample.cu",
    symbol="point_sample_backward",
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_int64]
    + [ctypes.c_void_p],
    replaces="ocrfdet_tpu/ops/point_sample.py:83")   # _bwd_kernel
ORDER_KERNEL = kernels.Kernel(     # the backward's binning of the points
    name="point_sample_order", source="point_sample.cu",
    symbol="point_sample_order",
    argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_int64]
    + [ctypes.c_void_p],
    replaces="ocrfdet_tpu/ops/point_sample.py:83")   # _bwd_kernel
MAX_C = 4
TILE = 16       # texels a side of the backward kernel's output tiles


def _tent(px, py, H: int, W: int):
    """x0 = floor(px), y0 = floor(py) and each axis' two tap weights,
    (1-t)*in0 and t*in1 (t the fractional part, in the tap's in-image
    flag, computed in float so that far-off points cannot overflow an
    integer index)."""
    def axis(t0, tt, n):
        w0 = (1.0 - tt) * ((t0 >= 0) & (t0 <= n - 1)).to(tt.dtype)
        w1 = tt * ((t0 + 1 >= 0) & (t0 + 1 <= n - 1)).to(tt.dtype)
        return w0, w1
    x0, y0 = torch.floor(px), torch.floor(py)
    return x0, y0, axis(x0, px - x0, W), axis(y0, py - y0, H)


def point_sample_points_plain(maps, px, py):
    """Plain PyTorch version of kernel K4. maps [BN,H,W,C] f32; px/py
    [BN,P] f32 pixel coordinates. Returns [BN,P,C] f32.

    Per axis the two tap weights are (1-t)*in0 and t*in1 (t the
    fractional part, in the tap's in-image flag); the four products
    add in the order (x0,y0), (x0+1,y0), (x0,y0+1), (x0+1,y0+1). The
    flags are computed in float, so far-off points cannot overflow an
    integer index."""
    BN, H, W, C = maps.shape
    P = px.shape[1]
    x0, y0, (wx0, wx1), (wy0, wy1) = _tent(px, py, H, W)
    flat = maps.reshape(BN, H * W, C)

    def tap(xs, ys):
        idx = (torch.clamp(ys, 0, H - 1) * W
               + torch.clamp(xs, 0, W - 1)).long()
        return torch.gather(flat, 1, idx[..., None].expand(BN, P, C))

    out = (wy0 * wx0)[..., None] * tap(x0, y0)
    out = out + (wy0 * wx1)[..., None] * tap(x0 + 1, y0)
    out = out + (wy1 * wx0)[..., None] * tap(x0, y0 + 1)
    out = out + (wy1 * wx1)[..., None] * tap(x0 + 1, y0 + 1)
    return out


def point_sample_order_plain(px, py, H: int, W: int, tile: int = TILE):
    """Plain version of the backward's binning, on any device. A point
    whose base tap (x0, y0) lies in [-1, W-1] x [-1, H-1] has a tap in the
    image; it goes into the bin (camera, tile row, tile column) of every
    tile one of its taps falls in: its base tap's (x0 = -1 counts as 0)
    and the next tile column or row where its second tap crosses into it.
    Its key there is (code << 32) | p, code = by * (tile + 1) + bx, (by,
    bx) the base tap's place in the tile's (tile + 1)^2 frame, which holds
    the halo row and column above and left of the tile. px/py [BN,P].
    Returns (ends [BN * ceil(H/tile) * ceil(W/tile)] int64, each bin's
    inclusive end in `order`; order int64, the keys of each bin in
    ascending order)."""
    BN, P = px.shape
    nty, ntx = -(-H // tile), -(-W // tile)
    dev = px.device
    fx, fy = torch.floor(px), torch.floor(py)
    inside = (fx >= -1) & (fx <= W - 1) & (fy >= -1) & (fy <= H - 1)
    x0 = torch.where(inside, fx, 0.0).long()
    y0 = torch.where(inside, fy, 0.0).long()
    tx, ty = x0.clamp(min=0) // tile, y0.clamp(min=0) // tile
    crosses = {"x": (x0 >= 0) & (x0 + 1 <= W - 1) & ((x0 + 1) % tile == 0),
               "y": (y0 >= 0) & (y0 + 1 <= H - 1) & ((y0 + 1) % tile == 0)}
    bn = torch.arange(BN, device=dev)[:, None]
    p = torch.arange(P, device=dev)[None, :]
    bins, keys = [], []
    for dy in (0, 1):
        for dx in (0, 1):
            keep = inside.clone()
            if dx:
                keep &= crosses["x"]
            if dy:
                keep &= crosses["y"]
            code = ((y0 - ((ty + dy) * tile - 1)) * (tile + 1)
                    + x0 - ((tx + dx) * tile - 1))
            b = (bn * nty + ty + dy) * ntx + tx + dx
            bins.append(b[keep])
            keys.append(((code << 32) | p)[keep])
    bins, keys = torch.cat(bins), torch.cat(keys)
    perm = torch.argsort(keys, stable=True)
    perm = perm[torch.argsort(bins[perm], stable=True)]
    counts = torch.bincount(bins, minlength=BN * nty * ntx)
    return torch.cumsum(counts, 0), keys[perm]


def point_sample_backward_walk_plain(px, py, grad_out, map_shape):
    """Plain version of K4's backward kernel, in its order: every texel
    (v, u) adds w * dout[p] over the points p with a tap of weight w != 0
    there, in the order base tap (v-1, u-1), (v-1, u), (v, u-1), (v, u)
    (its tap 3, 2, 1, 0), then point index, each product and each sum
    rounded in fp32, one contribution rank a pass: the kernel's bits.
    px/py [BN,P]; grad_out [BN,P,C]. Returns dmap [BN,H,W,C] f32."""
    BN, H, W, C = map_shape
    P = px.shape[1]
    dev = px.device
    dout = grad_out.float()
    x0, y0, (wx0, wx1), (wy0, wy1) = _tent(px, py, H, W)
    inside = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    taps = ((x0, y0, wy0 * wx0), (x0 + 1, y0, wy0 * wx1),
            (x0, y0 + 1, wy1 * wx0), (x0 + 1, y0 + 1, wy1 * wx1))
    tex, order, vals = [], [], []
    for k, (xs, ys, w) in enumerate(taps):
        keep = (inside & (w != 0) & (xs >= 0) & (xs <= W - 1) & (ys >= 0)
                & (ys <= H - 1))
        b, p = keep.nonzero(as_tuple=True)
        tex.append((b * H + ys[keep].long()) * W + xs[keep].long())
        order.append((3 - k) * P + p)
        vals.append(w[keep][:, None] * dout[b, p])
    tex, order, vals = torch.cat(tex), torch.cat(order), torch.cat(vals)
    perm = torch.argsort(order, stable=True)
    perm = perm[torch.argsort(tex[perm], stable=True)]
    tex, vals = tex[perm], vals[perm]
    _, runs = torch.unique_consecutive(tex, return_counts=True)
    starts = torch.cumsum(runs, 0) - runs
    rank = (torch.arange(tex.numel(), device=dev)
            - torch.repeat_interleave(starts, runs))
    by_rank = torch.argsort(rank, stable=True)
    tex, vals = tex[by_rank], vals[by_rank]
    acc = torch.zeros((BN * H * W, C), dtype=torch.float32, device=dev)
    r0 = 0
    for n in torch.bincount(rank).tolist():     # texels distinct in a rank
        t = tex[r0:r0 + n]
        acc[t] = acc[t] + vals[r0:r0 + n]
        r0 += n
    return acc.reshape(BN, H, W, C)


def point_sample_order(px, py, H: int, W: int):
    """The backward's binning on CUDA tensors (`ORDER_KERNEL`), as
    `point_sample_order_plain` with tile 16, but each bin's keys in no
    fixed order and each camera's bins in a span of 4 P keys of their
    own (a point lies in up to 4 tiles). Returns (spans [2, nbins] int64:
    bin b's keys are placed[spans[0, b]:spans[1, b]]; placed [4 BN P]
    int64). No host sync."""
    BN, P = px.shape
    nbins = BN * -(-H // TILE) * -(-W // TILE)
    counts = torch.empty(nbins + BN, dtype=torch.int32, device=px.device)
    spans = torch.empty((2, nbins), dtype=torch.int64, device=px.device)
    placed = torch.empty(4 * BN * P, dtype=torch.int64, device=px.device)
    ORDER_KERNEL.launch(kernels.ptr(px), kernels.ptr(py),
                        kernels.ptr(counts), kernels.ptr(spans),
                        kernels.ptr(placed), BN, H, W, P,
                        kernels.stream_of(px))
    return spans, placed


def point_sample_backward_ordered(px, py, dout, spans, placed, map_shape):
    """K4's backward kernel on CUDA tensors, given the binning (spans,
    placed) of `point_sample_order` (a bin of more than 512 keys is
    sorted in place): dmap [BN,H,W,C] f32, every value written."""
    BN, H, W, C = map_shape
    dmap = torch.empty((BN, H, W, C), dtype=torch.float32, device=px.device)
    BWD_KERNEL.launch(kernels.ptr(px), kernels.ptr(py), kernels.ptr(dout),
                      kernels.ptr(spans), kernels.ptr(placed),
                      kernels.ptr(dmap), BN, H, W, C, px.shape[1],
                      kernels.stream_of(px))
    return dmap


def binned_keys(spans, placed):
    """The keys of `point_sample_order`'s bins, each bin sorted, bin after
    bin: `point_sample_order_plain`'s `order`, whatever order the place
    kernel wrote (keys lie below 2^41, bins below 2^22)."""
    n = spans[1] - spans[0]
    bins = torch.repeat_interleave(torch.arange(n.numel(), device=n.device),
                                   n)
    at = (torch.repeat_interleave(spans[0] - torch.cumsum(n, 0) + n, n)
          + torch.arange(int(n.sum()), device=n.device))
    keys = placed[at]
    return keys[torch.argsort(bins * 2 ** 41 + keys)]


def _check_inputs(maps, px, py):
    """Raise unless K4's forward kernel can take these CUDA tensors."""
    if maps.dim() != 4 or px.dim() != 2:
        raise ValueError("point_sample: maps [BN,H,W,C] and px/py [BN,P] "
                         "expected")
    BN, H, W, C = maps.shape
    if not 0 < C <= MAX_C:
        raise ValueError(f"point_sample: C {C} outside (0, {MAX_C}]")
    if BN > 65535:
        raise ValueError(f"point_sample: {BN} maps, at most 65535")
    if H * W * C >= 2 ** 31:
        raise ValueError(f"point_sample: a map of {H * W * C} values, the "
                         f"kernel takes fewer than 2^31")
    for name, t in (("maps", maps), ("px", px), ("py", py)):
        if t.device != maps.device:
            raise ValueError(f"point_sample: {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"point_sample: {name} must be torch.float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"point_sample: {name} is not contiguous")
    if px.shape != py.shape or px.shape[0] != BN:
        raise ValueError(f"point_sample: px {tuple(px.shape)} / py "
                         f"{tuple(py.shape)} do not match maps "
                         f"{tuple(maps.shape)}")


# ------------------------------------------------ the custom ops of K4
@torch.library.custom_op(f"{kernels.OPS_NAMESPACE}::point_sample",
                         mutates_args=(), device_types="cpu")
def _point_sample_op(maps: torch.Tensor, px: torch.Tensor,
                     py: torch.Tensor) -> torch.Tensor:
    return point_sample_points_plain(maps, px, py)


@_point_sample_op.register_kernel("cuda")
def _(maps, px, py):
    _check_inputs(maps, px, py)
    BN, H, W, C = maps.shape
    P = px.shape[1]
    out = torch.empty((BN, P, C), dtype=torch.float32, device=maps.device)
    KERNEL.launch(kernels.ptr(maps), kernels.ptr(px), kernels.ptr(py),
                  kernels.ptr(out), BN, H, W, C, P, kernels.stream_of(maps))
    return out


@_point_sample_op.register_fake
def _(maps, px, py):
    return maps.new_empty((maps.shape[0], px.shape[1], maps.shape[3]))


@torch.library.custom_op(f"{kernels.OPS_NAMESPACE}::point_sample_backward",
                         mutates_args=(), device_types="cpu")
def _point_sample_backward_op(px: torch.Tensor, py: torch.Tensor,
                              dout: torch.Tensor, H: int,
                              W: int) -> torch.Tensor:
    BN, P = px.shape
    return point_sample_backward_walk_plain(px, py, dout.float(),
                                            (BN, H, W, dout.shape[-1]))


@_point_sample_backward_op.register_kernel("cuda")
def _(px, py, dout, H, W):
    BN, P = px.shape
    C = dout.shape[-1]
    dout = dout.float().contiguous()
    if tuple(dout.shape) != (BN, P, C):
        raise ValueError(f"point_sample backward: dout {tuple(dout.shape)}"
                         f" != {(BN, P, C)}")
    if P >= 2 ** 31:
        raise ValueError(f"point_sample backward: {P} points a map, the "
                         f"kernel takes fewer than 2^31")
    spans, placed = point_sample_order(px, py, H, W)
    return point_sample_backward_ordered(px, py, dout, spans, placed,
                                         (BN, H, W, C))


@_point_sample_backward_op.register_fake
def _(px, py, dout, H, W):
    return dout.new_empty((px.shape[0], H, W, dout.shape[-1]),
                          dtype=torch.float32)


def _point_sample_setup(ctx, inputs, output):
    maps, px, py = inputs
    ctx.save_for_backward(px, py)
    ctx.map_shape = tuple(maps.shape)


def _point_sample_grad(ctx, grad_out):
    px, py = ctx.saved_tensors
    return (point_sample_points_backward(px, py, grad_out, ctx.map_shape),
            None, None)


_point_sample_op.register_autograd(_point_sample_grad,
                                   setup_context=_point_sample_setup)


def point_sample_points_backward(px, py, grad_out, map_shape):
    """K4's backward (`ocrfdet::point_sample_backward`): px/py [BN,P] and
    the cotangent dout [BN,P,C] -> dmap [BN,H,W,C] f32. On CUDA tensors
    the binning, then the kernel; on CPU tensors
    `point_sample_backward_walk_plain`."""
    BN, H, W, C = map_shape
    if tuple(grad_out.shape) != (BN, px.shape[1], C):
        raise ValueError(f"point_sample backward: dout "
                         f"{tuple(grad_out.shape)} != {(BN, px.shape[1], C)}")
    return _point_sample_backward_op(px, py, grad_out, H, W)


def point_sample_points(maps, px, py):
    """K4 (`ocrfdet::point_sample`): maps [BN,H,W,C] f32 (C <= 4); px/py
    [BN,P] f32. Returns [BN,P,C] f32."""
    return _point_sample_op(maps, px, py)


def point_sample(maps, px, py):
    """Same contract as the JAX `point_sample_ref`: maps [B,N,H,W,C],
    px/py [B,N,P] in pixel coordinates; returns [B,N,P,C] f32."""
    B, N, H, W, C = maps.shape
    P = px.shape[-1]
    out = point_sample_points(
        maps.reshape(B * N, H, W, C).float().contiguous(),
        px.reshape(B * N, P).float().contiguous(),
        py.reshape(B * N, P).float().contiguous())
    return out.reshape(B, N, P, C)
