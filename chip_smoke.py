#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ocrfdet_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line:
  1. device: the card, its power limit; TF32 off for fp32 comparisons;
  2. build: compile the CUDA kernels from ocrfdet_tpu_torch/csrc/ (one
     nvcc per source, all at once) and the host NMS library;
  3. K1 (stereo cost volume), K2 (BEV pool), K3 (HT pool) and K4 (voxel
     point sample) at flagship shapes, each kernel vs its plain version;
  4. the BEVDepth slice (`ocrfdet_config(batch_size=1,
     with_ocrf=False)`) through `entry.infer` on a window of 30 requests
     after warm-up (2 K1 + 2 K2 launches per request), then one request
     in fp32 with the kernels and with their plain versions;
  5. the main path, the flagship OcRF slice (`ocrfdet_config(
     batch_size=1)`: OcRF + HOA, host NMS) through `entry.infer` on a
     window of 100 requests after 5 warm-up requests (exactly 2 launches
     of each of K1-K4 per request; latency median/p90, frames/s, host
     dispatch, device wait and host NMS times), then the fp32 request
     with the kernels and with their plain versions;
  6. one JSON line describing every kernel (launches from the main
     path's window), the card's name and power limit, and last
     `{"ok": true, "device": {...}}`.
Any failure raises and exits non-zero before the last line. It needs
CUDA and the repository around it; imports no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_FP32_FLOP_PER_S = 67e12    # fp32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` calls: the summed durations
    of the device kernels, copies and memsets it launches, as
    torch.profiler records them on the card. (A host clock or CUDA
    events around back-to-back calls would time the Python wrapper
    instead wherever a kernel runs shorter than its launch overhead.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.end - e.time_range.start
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return busy_us / reps / 1e3


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_k1(cfg, dev):
    """K1 at flagship shape on post-ReLU stem-like features with the
    frame-1 geometry of make_batch (1 m of ego motion)."""
    from ocrfdet_tpu_torch.entry import make_batch
    from ocrfdet_tpu_torch.geometry.frustum import make_frustum
    from ocrfdet_tpu_torch.ops import cost_volume as cvm

    batch = make_batch(cfg, seed=0, device=dev)
    H, W = cfg.data.input_size
    ds = cfg.vt.depthnet.cv_downsample
    Hc, Wc, C, N = H // ds, W // ds, 256, cfg.data.num_cams
    g = torch.Generator(device=dev).manual_seed(0)
    curr = torch.randn((1, N, Hc, Wc, C), generator=g, device=dev).relu_()
    prev = torch.randn((1, N, Hc, Wc, C), generator=g, device=dev).relu_()
    prev = prev.to(torch.bfloat16)    # the main path's prev is a bf16 stem
    frustum = torch.from_numpy(make_frustum(cfg.grid.depth, (H, W),
                                            ds)).to(dev)
    f = 1
    az, bz, a2, b2 = cvm.homography_coeffs(
        frustum, batch["k2s_sensor"][:, f], batch["intrins"][:, f],
        batch["post_rots"][:, f], batch["post_trans"][:, f], (H, W),
        (Hc, Wc))
    depths = frustum[:, 0, 0, 2].contiguous()
    bias = cfg.vt.depthnet.cost_volume_bias
    args = (curr, prev, depths, az, bz, a2, b2, bias)
    got = cvm.cost_volume(*args)
    want = cvm.cost_volume_plain(*args)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    flips = int((diff > bias / 2).sum())
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp_min(1e-6)).max())
    # tolerance: another channel-sum order only (the coordinates round
    # identically, so no flag may flip)
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-3))
    ms = device_ms(lambda: cvm.cost_volume(*args), reps=20)
    plain_ms = device_ms(lambda: cvm.cost_volume_plain(*args), reps=2)
    # the work this data needs: 2 flops per channel per in-image tap,
    # 3 per channel per sample (sub, abs, add)
    den = depths[None, :, None] * az.reshape(N, 1, -1) + bz.reshape(N, 1, 1)
    front = den >= 1e-3
    safe = torch.where(front, den, torch.ones_like(den))
    px = (depths[None, :, None] * a2[..., 0].reshape(N, 1, -1)
          + b2[..., 0].reshape(N, 1, 1)) / safe
    py = (depths[None, :, None] * a2[..., 1].reshape(N, 1, -1)
          + b2[..., 1].reshape(N, 1, 1)) / safe
    taps = 0
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = px.floor() + dx, py.floor() + dy
            taps += int((front & (xi >= 0) & (xi <= Wc - 1) & (yi >= 0)
                         & (yi <= Hc - 1)).sum())
    samples = want.numel()
    flops = C * (2 * taps + 3 * samples)
    coef_bytes = (az.numel() + a2.numel() + bz.numel() + b2.numel()) * 4
    moved = nbytes(curr, prev, depths, want) + coef_bytes
    bound_ms, bound_by = bound(moved, flops)
    log(f"[k1] cost_volume {tuple(got.shape)}: max_abs_err {max_abs:.3e} "
        f"max_rel_err {max_rel:.3e} flag_flips {flips} (tol rtol 1e-5 "
        f"atol 1e-3: {'ok' if ok else 'FAIL'}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms; bound {bound_ms:.4f} ms by {bound_by} "
        f"({moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP, "
        f"{taps / samples:.3f} in-image taps per sample)")
    if not ok:
        raise AssertionError("K1 kernel disagrees with its plain version")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_k2(cfg, dev):
    """K2 at flagship shape: the key frame's frustum over the BEV grid,
    softmaxed random depth, random context."""
    from ocrfdet_tpu_torch.entry import make_batch
    from ocrfdet_tpu_torch.geometry import frustum as FR
    from ocrfdet_tpu_torch.ops import bev_pool as bp

    batch = make_batch(cfg, seed=0, device=dev)
    grid = cfg.grid
    H, W = cfg.data.input_size
    frustum = torch.from_numpy(FR.make_frustum(grid.depth, (H, W),
                                               cfg.vt.downsample)).to(dev)
    coor = FR.frustum_to_ego(frustum, batch["rots"][:, 0],
                             batch["trans"][:, 0], batch["intrins"][:, 0],
                             batch["post_rots"][:, 0],
                             batch["post_trans"][:, 0], batch["bda"])
    X, Y = grid.bev_size
    vox, valid = FR.voxel_indices(coor, (grid.x[0], grid.y[0], grid.z[0]),
                                  (grid.x[2], grid.y[2], grid.z[2]),
                                  (X, Y, 1))
    D, fH, fW = frustum.shape[:3]
    N, C = cfg.data.num_cams, cfg.vt.out_channels
    g = torch.Generator(device=dev).manual_seed(1)
    depth = torch.randn((1, N, D, fH, fW), generator=g,
                        device=dev).softmax(2)
    feat = torch.randn((1, N, fH, fW, C), generator=g, device=dev)
    w, pix, cell, featp, cells = bp.lss_points(depth, feat, vox, valid,
                                               (X, Y, 1))
    got = bp.bev_pool_points(w, pix, cell, featp, cells)
    want = bp.bev_pool_points_plain(w, pix, cell, featp, cells)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    # atomics reorder fp32 sums: rtol 1e-5 / atol 1e-5
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
    ms = device_ms(lambda: bp.bev_pool_points(w, pix, cell, featp, cells),
                 reps=50)
    plain_ms = device_ms(
        lambda: bp.bev_pool_points_plain(w, pix, cell, featp, cells), reps=10)
    # yardstick: one index_add_ of the precomputed weighted rows
    keep = cell[0] < cells
    rows = featp[0, pix[0, keep].long()] * w[0, keep, None]
    idx = cell[0, keep].long()
    acc = torch.zeros((cells, C), device=dev)
    library_ms = device_ms(lambda: acc.index_add_(0, idx, rows), reps=50)
    n_valid = int(keep.sum())
    moved = nbytes(w, pix, cell, featp, want)
    bound_ms, bound_by = bound(moved, 2 * C * n_valid)
    log(f"[k2] bev_pool {tuple(got.shape)}: max_abs_err {max_abs:.3e} "
        f"(tol rtol 1e-5 atol 1e-5: {'ok' if ok else 'FAIL'}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} "
        f"ms; bound {bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.2f} MB, "
        f"{n_valid} of {w.numel()} points in the grid)")
    if not ok:
        raise AssertionError("K2 kernel disagrees with its plain version")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def flagship_projection(cfg, dev):
    """The key frame's HT projection (uvd, valid) of make_batch."""
    from ocrfdet_tpu_torch.entry import make_batch
    from ocrfdet_tpu_torch.geometry import frustum as FR

    batch = make_batch(cfg, seed=0, device=dev)
    grid, vt = cfg.grid, cfg.vt
    cams = [batch[k][:, 0] for k in ("rots", "trans", "intrins",
                                     "post_rots", "post_trans")]
    l2i, aug = FR.ego_to_image(*cams, batch["bda"])
    ref = torch.from_numpy(FR.ht_reference_points(
        vt.bev_h, vt.bev_w, vt.num_height,
        z_pillar=grid.z[1] - grid.z[0])).to(dev)
    return FR.project_points(ref, grid.pc_range, (grid.depth[0],
                                                  grid.depth[1]),
                             l2i, aug, cfg.data.input_size)


def check_k3(cfg, dev):
    """K3 at flagship shape: the key frame's projection, thresholded
    softmax depth, random context."""
    from ocrfdet_tpu_torch.ops import ht_pool as htp

    uvd, valid = flagship_projection(cfg, dev)
    N, D, C = cfg.data.num_cams, cfg.grid.num_depth_bins, cfg.vt.out_channels
    h = cfg.data.input_size[0] // cfg.vt.downsample
    w = cfg.data.input_size[1] // cfg.vt.downsample
    g = torch.Generator(device=dev).manual_seed(2)
    depth = torch.randn((1, N, h, w, D), generator=g, device=dev).softmax(-1)
    depth = torch.where(depth < cfg.vt.depth_threshold / D,
                        torch.zeros_like(depth), depth)
    ctx = torch.randn((1, N, h, w, C), generator=g, device=dev)
    args = htp.ht_pool_inputs(depth, ctx, uvd, valid)
    got = htp.ht_pool_points(*args)
    want = htp.ht_pool_points_plain(*args)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    scale = float(want.abs().max())
    # the plain version sums the heights in its own order: rtol 1e-5,
    # atol 1e-5 of the output scale
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale))
    ms = device_ms(lambda: htp.ht_pool_points(*args), reps=50)
    plain_ms = device_ms(lambda: htp.ht_pool_points_plain(*args), reps=5)
    n_valid = int(args[4].sum())
    moved = nbytes(*args, want)
    bound_ms, bound_by = bound(moved, n_valid * (2 * C + 1))
    log(f"[k3] ht_pool {tuple(got.shape)}: max_abs_err {max_abs:.3e} "
        f"(max |out| {scale:.3f}; tol rtol 1e-5 atol 1e-5 x scale: "
        f"{'ok' if ok else 'FAIL'}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, no library call; bound {bound_ms:.4f} ms by "
        f"{bound_by} ({moved / 1e6:.2f} MB, {n_valid} of "
        f"{args[4].numel()} points valid)")
    if not ok:
        raise AssertionError("K3 kernel disagrees with its plain version")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_k4(cfg, dev):
    """K4 at flagship shape: random alpha maps at full image resolution
    (C = 1, as at eval) sampled at the key frame's projected points."""
    import torch.nn.functional as F
    from ocrfdet_tpu_torch.ops import point_sample as ps

    uvd, _ = flagship_projection(cfg, dev)
    N = cfg.data.num_cams
    H, W = cfg.vt.render_image_size
    P = uvd.shape[2] * uvd.shape[3]
    g = torch.Generator(device=dev).manual_seed(3)
    maps = torch.rand((N, H, W, 1), generator=g, device=dev)
    px = (uvd[0, ..., 0] * W).reshape(N, P).contiguous()
    py = (uvd[0, ..., 1] * H).reshape(N, P).contiguous()
    got = ps.point_sample_points(maps, px, py)
    want = ps.point_sample_points_plain(maps, px, py)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    # the same separately rounded products and sums: rtol 1e-5 / atol 1e-6
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))
    ms = device_ms(lambda: ps.point_sample_points(maps, px, py), reps=50)
    plain_ms = device_ms(lambda: ps.point_sample_points_plain(maps, px, py),
                       reps=10)
    # yardstick: one F.grid_sample (align_corners=False: x_n = (2 px +
    # 1) / W - 1) of the same maps at the same points
    grid = torch.stack([(2 * px + 1) / W - 1, (2 * py + 1) / H - 1],
                       -1)[:, None]
    maps_nchw = maps.permute(0, 3, 1, 2).contiguous()

    def library():
        return F.grid_sample(maps_nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=False)
    lib_err = float((library()[:, 0, 0] - got[..., 0]).abs().max())
    library_ms = device_ms(library, reps=50)
    moved = nbytes(maps, px, py, want)
    # operations: 4 products and 3 sums per output value, ~12 per point
    # for its tap weights
    bound_ms, bound_by = bound(moved, 7 * got.numel() + 12 * px.numel())
    log(f"[k4] point_sample {tuple(got.shape)}: max_abs_err {max_abs:.3e} "
        f"(tol rtol 1e-5 atol 1e-6: {'ok' if ok else 'FAIL'}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample "
        f"{library_ms:.4f} ms (max |diff| to it {lib_err:.3e}); bound "
        f"{bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.2f} MB)")
    if not ok:
        raise AssertionError("K4 kernel disagrees with its plain version")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel wrappers to their plain versions (for a
    reference run on the card)."""
    from ocrfdet_tpu_torch.ops import bev_pool as bp
    from ocrfdet_tpu_torch.ops import cost_volume as cvm
    from ocrfdet_tpu_torch.ops import ht_pool as htp
    from ocrfdet_tpu_torch.ops import point_sample as ps
    with mock.patch.object(cvm, "cost_volume", cvm.cost_volume_plain), \
            mock.patch.object(bp, "bev_pool_points",
                              bp.bev_pool_points_plain), \
            mock.patch.object(htp, "ht_pool_points",
                              htp.ht_pool_points_plain), \
            mock.patch.object(ps, "point_sample_points",
                              ps.point_sample_points_plain):
        yield


def percentile(xs, q: float) -> float:
    """The q-th percentile of xs (nearest rank)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, round(q / 100 * len(xs)) - 1))]


def check_slice(cfg, dev, tag, path_kernels, all_kernels, n_requests,
                n_batches=8, n_warmup=5):
    """Answer `n_requests` flagship requests (cycling over make_batch
    seeds 0..n_batches-1) through `entry.infer` after `n_warmup` warm-up
    requests, one at a time as a server would. Every kernel's count is
    set to 0 just before the window and read just after: each of
    `path_kernels` must have launched exactly twice per request (once
    per temporal frame), every other kernel never. Per request it takes
    the host-clock times `entry.infer` records (dispatch of the forward
    and decode, the wait for the decoded boxes, host NMS) and the whole
    request (until `entry.infer` returns); over the window, the main
    thread's CPU time (the thread CPU clock may tick only every few ms,
    too coarse for one request)."""
    from ocrfdet_tpu_torch import entry
    from ocrfdet_tpu_torch.models.detector import OcRFDet

    t0 = time.perf_counter()
    model = entry.build_detector(cfg, dev, seed=0)
    log(f"[{tag}] built the flagship with_ocrf={cfg.with_ocrf} detector on "
        f"{dev} ({sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
        f"params, {time.perf_counter() - t0:.1f} s)")
    batches = [entry.make_batch(cfg, seed=s, device=dev)
               for s in range(n_batches)]
    for i in range(n_warmup):
        entry.infer(model, batches[i % n_batches])
    torch.cuda.synchronize()
    for k in all_kernels:
        k.launches = 0
    wall, parts, outs = [], [], []
    t_window, cpu_window = time.perf_counter(), time.thread_time()
    for i in range(n_requests):
        timings = {}
        t = time.perf_counter()
        out = entry.infer(model, batches[i % n_batches], timings=timings)
        wall.append(time.perf_counter() - t)
        parts.append(timings)
        if i < n_batches:
            outs.append(out)
    torch.cuda.synchronize()
    window = time.perf_counter() - t_window
    cpu_window = time.thread_time() - cpu_window
    launches = {k.name: k.launches for k in all_kernels}
    for k in all_kernels:
        want = 2 * n_requests if k in path_kernels else 0
        if launches[k.name] != want:
            raise AssertionError(f"{k.name}: {launches[k.name]} launches "
                                 f"over {n_requests} requests, expected "
                                 f"{want}")
    D = cfg.grid.num_depth_bins
    N = cfg.data.num_cams
    h = cfg.data.input_size[0] // cfg.vt.downsample
    w = cfg.data.input_size[1] // cfg.vt.downsample
    Y, X = cfg.vt.bev_h, cfg.vt.bev_w
    logit_keys = (("bev_mask_logit", "opacity_bev_logit") if cfg.with_ocrf
                  else ())
    for preds, aux, decoded, dets in outs:
        heat = preds[0]["heatmap"]
        if tuple(heat.shape) != (1, Y, X, 1):
            raise AssertionError(f"heatmap shape {tuple(heat.shape)}")
        if tuple(aux["depth"].shape) != (1, N, h, w, D):
            raise AssertionError(f"depth shape {tuple(aux['depth'].shape)}")
        for k in logit_keys:
            if tuple(aux[k].shape) != (1, Y, X, 1):
                raise AssertionError(f"{k} shape {tuple(aux[k].shape)}")
        tensors = [v for p in preds for v in p.values()]
        tensors += [aux[k] for k in ("depth", "semantic") + logit_keys]
        tensors += [d.boxes for d in decoded] + [d.scores for d in decoded]
        for t in tensors:
            if not bool(torch.isfinite(t).all()):
                raise AssertionError("non-finite output")
        if float((aux["depth"].sum(-1) - 1).abs().max()) > 1e-3:
            raise AssertionError("depth is not a distribution over bins")
        if len(dets) != 1 or dets[0]["boxes"].shape[1:] != (9,) \
                or not np.isfinite(dets[0]["boxes"]).all():
            raise AssertionError("malformed detections")

    def ms(xs, q):
        return f"{percentile(xs, q) * 1e3:.3f}"

    def col(name):
        return [p[name] for p in parts]
    valid = sum(int(d.valid.sum()) for d in outs[0][2])
    log(f"[{tag}] {n_requests} requests after {n_warmup} warm-up (batch 1, "
        f"{cfg.total_frames} frames x {N} cams at {cfg.data.input_size}, "
        f"{cfg.compute_dtype}) in a {window:.3f} s window: "
        f"{n_requests / window:.3f} frames/s; latency ms median "
        f"{ms(wall, 50)} p90 {ms(wall, 90)} min {ms(wall, 0)} max "
        f"{ms(wall, 100)}; host dispatch ms median "
        f"{ms(col('dispatch'), 50)} p90 {ms(col('dispatch'), 90)}, "
        f"{sum(col('dispatch')) / sum(wall):.2%} of the requests' time; "
        f"wait for the device ms median {ms(col('wait'), 50)}; main thread "
        f"on CPU {cpu_window:.3f} s of the window "
        f"({cpu_window / window:.2%}); launches {launches}")
    log(f"[{tag}] decode + NMS on the host: NMS ms median "
        f"{ms(col('nms'), 50)} p90 {ms(col('nms'), 90)}, copy of the "
        f"decoded boxes (after the device is done) in the wait above; "
        f"{valid} decoded boxes above threshold -> "
        f"{len(outs[0][3][0]['boxes'])} detections (request 0)")

    # the same request in fp32, with the kernels and with the plain
    # versions, on the same weights
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    m32 = OcRFDet(cfg32)
    m32.load_state_dict(model.state_dict())
    m32 = m32.eval().to(dev)
    del model
    before = [k.launches for k in all_kernels]
    k_preds, k_aux, _, _ = entry.infer(m32, batches[0])
    after = [k.launches for k in all_kernels]
    with plain_versions():
        p_preds, p_aux, _, _ = entry.infer(m32, batches[0])
    torch.cuda.synchronize()
    plain_after = [k.launches for k in all_kernels]
    for k, b, a, p in zip(all_kernels, before, after, plain_after):
        want = 2 if k in path_kernels else 0
        if a != b + want or p != a:
            raise AssertionError(
                f"{k.name}: {a - b} launches in the fp32 kernel run "
                f"(expected {want}), {p - a} in the plain run (expected 0)")
    compared = [("heatmap", k_preds[0]["heatmap"], p_preds[0]["heatmap"]),
                ("depth", k_aux["depth"], p_aux["depth"])]
    compared += [(k, k_aux[k], p_aux[k]) for k in logit_keys[1:]]
    errs = {name: (float((a - b).abs().max()), float(b.abs().max()))
            for name, a, b in compared}
    bf_heat = float((outs[0][0][0]["heatmap"].float()
                     - p_preds[0]["heatmap"]).abs().max())
    bf_depth = float((outs[0][1]["depth"] - p_aux["depth"]).abs().max())
    log(f"[{tag}] fp32 kernels vs fp32 plain: " + ", ".join(
        f"{name} max_abs_err {e:.3e} (max |{name}| {sc:.3f})"
        for name, (e, sc) in errs.items())
        + f"; bf16 kernels (as configured) vs fp32 plain: heatmap "
        f"{bf_heat:.3e}, depth {bf_depth:.3e}")
    # tolerance: the kernels differ from their plain versions only in
    # fp32 summation order: the heatmap and the opacity logit 1e-3 of
    # their scale, the depth probabilities 1e-5
    for name, (err, scale) in errs.items():
        tol = 1e-5 if name == "depth" else 1e-3 * max(1.0, scale)
        if err > tol:
            raise AssertionError(f"{name}: kernels vs plain {err:.3e} > "
                                 f"{tol:.1e}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from ocrfdet_tpu_torch import kernels
    from ocrfdet_tpu_torch.config import ocrfdet_config
    from ocrfdet_tpu_torch.ops import bev_pool as bp
    from ocrfdet_tpu_torch.ops import cost_volume as cvm
    from ocrfdet_tpu_torch.ops import ht_pool as htp
    from ocrfdet_tpu_torch.ops import nms
    from ocrfdet_tpu_torch.ops import point_sample as ps

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; TF32 off for "
        f"cuDNN and matmul (fp32 comparisons)")

    t = time.perf_counter()
    kernel_list = [cvm.KERNEL, bp.KERNEL, htp.KERNEL, ps.KERNEL]
    kernels.build(kernel_list)
    nms.native_library()
    log(f"[build] {', '.join(k.source for k in kernel_list)} (nvcc) and "
        f"nms.cpp (c++) -> {kernels.BUILD_DIR.name}/ in "
        f"{time.perf_counter() - t:.1f} s")

    cfg = ocrfdet_config(batch_size=1)
    lss_cfg = ocrfdet_config(batch_size=1, with_ocrf=False)
    stats = {"cost_volume": check_k1(cfg, dev),
             "bev_pool": check_k2(cfg, dev),
             "ht_pool": check_k3(cfg, dev),
             "point_sample": check_k4(cfg, dev)}
    check_slice(lss_cfg, dev, "lss", kernel_list[:2], kernel_list,
                n_requests=30)
    torch.cuda.empty_cache()
    launches = check_slice(cfg, dev, "ocrf", kernel_list, kernel_list,
                           n_requests=100)

    rows = []
    for k in kernel_list:
        rows.append(dict(name=k.name, route="cuda",
                         source=f"ocrfdet_tpu_torch/csrc/{k.source}",
                         replaces=k.replaces, launches=launches[k.name],
                         **stats[k.name]))
    log(json.dumps({"kernels": rows}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
