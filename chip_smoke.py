#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ocrfdet_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line:
  1. device: the card, its power limit; TF32 off for fp32 comparisons;
  2. build: compile the CUDA kernels from ocrfdet_tpu_torch/csrc/ (one
     nvcc per source, all at once) and the host NMS library;
  3. K1 (stereo cost volume), K2 (BEV pool), K3 (HT pool) and K4 (voxel
     point sample) at flagship shapes, at the eval path's batch 1 and the
     training step's batch 2, each kernel vs its plain version (K1 also
     counts the tap rows it loads with its load-counting build, which
     must equal its design's rule; K2 times its preparation and its
     kernel apart, prints its longest cell interval and must give the
     same bits on two runs; K3 must give the same bits on two runs, is
     timed beside F.embedding_bag and prints the index bytes it stages
     and its valid points a pillar; K4 must give its plain version's
     bits), and the backward kernels of K2, K3 and K4 at the training
     step's shapes (batch 2) on random cotangents, each vs its plain
     version's autograd (K2's by both ways of naming a pixel's points,
     the LSS layout and the points sorted by pixel, each the same bits
     on two runs and the two the same bits as each other; K3's ordering
     equal to its plain version, the ordering and the kernel timed
     apart, its longest row, the same bits on two runs; K4's binning
     holding its plain version's keys, dmap the bits of the plain walk
     in the kernel's order and the same bits on two runs, the backward,
     its binning and its kernel each timed by three traces and by CUDA
     events, its bound counting only the dout rows it must read);
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
  6. the main path of the training slice: the flagship trainer
     (`ocrfdet_config(batch_size=2)`, bf16 towers, OcRF render branch)
     through `entry.train_step`: 3 warm-up steps (the first records K5's
     input streams), then a window of 10 timed steps with exactly 2
     launches of K1 and of each forward of K2-K4, 1 of each of their
     backwards (and of K3's backward ordering and K4's binning) and 1 of
     K5's forward and backward per step (the key frame alone is
     differentiated); every loss finite, no step skipped;
  7. K5 forward and backward on those recorded flagship streams vs its
     plain version (each twice, the same bits; the bound's
     special-function term counted from the streams, beside the MUFU
     instructions in the compiled code; an estimate of the forward's and
     the backward's issue slots per (warp, Gaussian) step);
  8. one fp32 step at batch 1 from the same weights and batch with the
     kernels (three times), with the plain versions, with K2-K5 plain and
     K1's kernel, with each kernel alone plain, and with K1 and with K2
     jittered by one rounding (the kernels' runs and K2 jittered with
     three seeds set the noise floor): losses, per-module gradient norms,
     gradient difference;
  9. the trainer and the eval runner from disk: a fake nuScenes
     (rendered scenes, 6 cameras at 900 x 1600) under build/, the
     flagship `Trainer` at batch 2 from the CBGS dataset and the 8-thread
     loader: 2 steps of epoch 0 (with_prev 0, no box mask), `save`, a
     new trainer's `resume` (returns 1, the whole state equal), 2 steps
     of epoch 2 (with_prev 1, box mask on); each step exactly the
     per-step launches of phase 6; step ms, frames/s, the loader wait
     per step, peak memory; then `run_eval` of the EMA weights over 4
     held-out samples at batch 1 (exactly 2 launches of each of K1-K4
     per request; the metrics dict, the results JSON's sample count);
 10. K1, K2-K4 forward and K2-K4 backward at the GeoEnhDet training
     step's batch 4, each against its plain version with the batch-1
     and batch-2 tolerances; then K1 at batch 1, 2 and 4 timed by the
     profiler's traces and by CUDA events around the same calls;
 11. GeoEnhDet training (`geoenh_config()`: batch 4, 512-channel FPN,
     the VGGT-1B teacher at 294 x 518 with seeded random weights, bf16
     towers) through `entry.train_step`: 3 warm-up steps, a window of 5
     timed steps with exactly phase 6's launches a step; every loss
     finite (both KD losses), no step skipped; the teacher bitwise
     unchanged, frozen, with no optimizer moments and no EMA copy;
     parameter counts, step ms, frames/s, peak memory; the teacher's and
     the KD branch's forward device time from one traced step; the
     teacher's bf16 tokens against fp32 (relative RMS); one teacher
     forward's device time by kernel group;
 12. GeoEnhDet eval (`geoenh_config(batch_size=1)`) through
     `entry.infer`: 20 requests, 2 launches of each of K1-K4 a request,
     the teacher and the aligner never called; latency; then the fp32
     request with the kernels and with their plain versions, as phase 5;
 13. the 8-frame variant (`ocrfdet_8f_config(batch_size=1)`) through
     `entry.infer`: 20 requests, 8 launches of each of K1-K4 a request,
     latency, then the fp32 request with the kernels and with their
     plain versions, as phase 5;
 14. the measuring tools (`ocrfdet_tpu_torch/tools/`): `step_variants`
     in this process at flagship batch 2 (full, the "sample", "splat"
     and "render" seams, no_stereo and no_ocrf, interleaved, 2 warm-up
     and 3 timed steps each; each variant's kernel launches a step must
     equal `variant_launches`' table; step median and busy time a
     step), `benchmark_infer` (flagship, 3 warm-up + 20), `get_flops`
     (flagship, eval and train; the kernels' rows from ops/work.py) and
     `profile_step --fwd-only` (its categories must add up to its busy
     time within 1%);
 15. `[export]`: the flagship inference program (`tools/export.py`:
     forward + decode, K1-K4 as custom-op nodes) exported in fp32 and in
     the configured bf16, saved under build/ and loaded back; on 4
     requests the fp32 program gives eager's bits and the bf16 one
     agrees within phase 5's bound, each launching 2 of each of K1-K4 a
     request; 20 bf16 requests through it and through eager, A B A B;
 16. `[ddp]`: the data axis (`parallel/`) at world size 1 over NCCL:
     the flagship at batch 2 as a data rank beside the single-device
     state, 3 steps of the one `train_step` under deterministic
     algorithms (`deterministic_step`): losses, gradients, parameters
     and buffers bit for bit every step, the gathered ZeRO state equal;
     `run_eval` with and without the process group the same;
 17. `[space]`: the space axis (`parallel/`, the detector's camera
     blocks, BEV row blocks and render bands) at 2 ranks on the one
     card, two processes of this script (`--space-rank`) over gloo
     (NCCL refuses two ranks on one device), against the single device
     in this process (`check_space`): the flagship's fp32 request and
     the gradients of a fixed functional of it, 20 bf16 requests, 3
     fp32 training steps on camera-0-duplicated batches against a
     rounding floor; each rank's launches (2 of each of K1-K4 a
     request, phase 6's a step, K5 on a 128-row band), step ms, peak
     memory and collectives, and every kernel against its plain version
     on the inputs a rank gave it;
 18. one JSON line describing every kernel (the nine kernel functions
     and K4's backward binning; launches from the training window;
     forwards timed at batch 1 with their batch-2 times under `*_b2`
     and the batch-4 times under `*_b4`; a space rank's launches over
     its 3 steps and the largest error against the plain version at a
     rank's shapes under `launches_space` and `max_abs_err_space`), the
     card's name and power limit, and last `{"ok": true, "device":
     {...}}`.
Any failure raises and exits non-zero before the last line. It needs
CUDA and the repository around it; imports no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from ocrfdet_tpu_torch.ops import work
from ocrfdet_tpu_torch.ops.work import bound, nbytes


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` calls: the median of
    `device_ms_traces`."""
    return float(np.median(device_ms_traces(fn, reps, warmup)))


def device_ms_traces(fn, reps: int, warmup: int = 1) -> list:
    """Mean device time of fn() over `reps` calls in each of three traces:
    the summed durations of the device kernels, copies and memsets it
    launches, as torch.profiler records them on the card. (A host clock
    or CUDA events around back-to-back calls would time the Python
    wrapper instead wherever a kernel runs shorter than its launch
    overhead.) The profiler now and then loses a device event, so each
    trace scales its sum by the events it should hold (k per call, k the
    nearest whole number to its events / reps) over those it holds; a
    trace with under half an event per call counts for nothing, and CUDA
    events time the calls when no trace counts."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    estimates = []
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if _is_kernel(e)]
        k = round(len(spans) / reps)
        if k >= 1:
            estimates.append(sum(spans) * k / len(spans) / 1e3)
    if estimates:
        return estimates
    log("[timing] the profiler recorded under half an event per call in "
        "three traces; CUDA events time this call")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) / reps]


def _is_kernel(e) -> bool:
    """A device event of the trace that is no range drawn on the device's
    timeline (the program's `ocrfdet.` spans, `record_function`)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def device_ms_by_kernel(fn, reps: int) -> dict:
    """{device kernel or memset name: mean device ms per call of fn()} from
    one torch.profiler trace of `reps` calls (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if _is_kernel(e):
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("::")[-1].strip()
            out[name] = out.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def close(got, want, rtol, atol_scale):
    """(max |got - want|, scale, ok) with atol = atol_scale x scale."""
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol_scale * scale))
    return err, scale, ok


def plain_grads(fn, args, diff, cot):
    """Gradients of <fn(*args), cot> w.r.t. args[i] for i in diff, and a
    closure that recomputes them (for timing)."""
    args = [a.detach().clone().requires_grad_(i in diff)
            if torch.is_tensor(a) else a for i, a in enumerate(args)]
    out = fn(*args)
    inputs = [args[i] for i in diff]

    def again():
        return torch.autograd.grad(out, inputs, cot, retain_graph=True)
    return again(), again


def k1_inputs(cfg, dev, B):
    """K1's arguments at flagship shape, batch B: post-ReLU stem-like
    features with the frame-1 geometry of make_batch (1 m of ego
    motion)."""
    from ocrfdet_tpu_torch.entry import make_batch
    from ocrfdet_tpu_torch.geometry.frustum import make_frustum
    from ocrfdet_tpu_torch.ops import cost_volume as cvm

    batch = make_batch(cfg, seed=0, batch_size=B, device=dev)
    H, W = cfg.data.input_size
    ds = cfg.vt.depthnet.cv_downsample
    Hc, Wc, C, N = H // ds, W // ds, 256, cfg.data.num_cams
    g = torch.Generator(device=dev).manual_seed(0)
    curr = torch.randn((B, N, Hc, Wc, C), generator=g, device=dev).relu_()
    prev = torch.randn((B, N, Hc, Wc, C), generator=g, device=dev).relu_()
    prev = prev.to(torch.bfloat16)    # the main path's prev is a bf16 stem
    frustum = torch.from_numpy(make_frustum(cfg.grid.depth, (H, W),
                                            ds)).to(dev)
    f = 1
    az, bz, a2, b2 = cvm.homography_coeffs(
        frustum, batch["k2s_sensor"][:, f], batch["intrins"][:, f],
        batch["post_rots"][:, f], batch["post_trans"][:, f], (H, W),
        (Hc, Wc))
    depths = frustum[:, 0, 0, 2].contiguous()
    return (curr, prev, depths, az, bz, a2, b2,
            cfg.vt.depthnet.cost_volume_bias)


def _k1_case(cfg, dev, B):
    """K1 at flagship shape, batch B (`k1_inputs`), against its plain
    version, and its row loads counted."""
    from ocrfdet_tpu_torch.ops import cost_volume as cvm

    args = k1_inputs(cfg, dev, B)
    curr, prev, depths, az, bz, a2, b2, bias = args
    got = cvm.cost_volume(*args)
    want = cvm.cost_volume_plain(*args)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    flips = int((diff > bias / 2).sum())
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp_min(1e-6)).max())
    # tolerance: another channel-sum order only (the coordinates round
    # identically, so no flag may flip)
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-3)) and flips == 0
    ms = device_ms(lambda: cvm.cost_volume(*args), reps=20)
    plain_ms = device_ms(lambda: cvm.cost_volume_plain(*args), reps=2)
    # the work this data needs (ops/work.py), and the tap rows the
    # kernel's load-counting build loads against its design's rule
    wk = work.cost_volume_work(curr, prev, depths, az, bz, a2, b2, want)
    taps, model, moved, flops = (wk["taps"], wk["row_loads"], wk["bytes"],
                                 wk["flops"])
    loads = cvm.cost_volume_row_loads(*args)
    samples = want.numel()
    bound_ms, bound_by = bound(moved, flops)
    log(f"[k1] cost_volume batch {B} {tuple(got.shape)}: max_abs_err "
        f"{max_abs:.3e} max_rel_err {max_rel:.3e} flag_flips {flips} (tol "
        f"rtol 1e-5 atol 1e-3, 0 flips: {'ok' if ok else 'FAIL'}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms by "
        f"{bound_by} ({moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); per "
        f"sample {taps / samples:.3f} in-image taps, {loads / samples:.3f} "
        f"row loads counted by the kernel's load-counting build "
        f"({model / samples:.3f} by the design's rule on the host: "
        f"{'equal' if loads == model else 'DIFFERENT'})")
    if not ok:
        raise AssertionError(f"K1 kernel disagrees with its plain version "
                             f"at batch {B}")
    if loads != model:
        raise AssertionError(f"K1 loaded {loads} tap rows at batch {B}, its "
                             f"design {model}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                row_loads_per_sample=loads / samples)


def with_b2(b1, b2, keys=("ms", "plain_ms", "bound_ms", "library_ms")):
    """A kernel's batch-1 stats with its batch-2 times under `<key>_b2`."""
    out = dict(b1)
    out["max_abs_err"] = max(b1["max_abs_err"], b2["max_abs_err"])
    out.update({f"{k}_b2": b2[k] for k in keys})
    return out


def check_k1(cfg, dev):
    """K1 at the eval path's batch 1 and the training step's batch 2 (the
    12-volume stack)."""
    b1, b2 = _k1_case(cfg, dev, 1), _k1_case(cfg, dev, 2)
    return with_b2(b1, b2, ("ms", "plain_ms", "bound_ms", "library_ms",
                            "row_loads_per_sample"))


def flagship_lss_inputs(cfg, dev, B, seed):
    """The LSS splat's inputs of the key frame of make_batch at batch B:
    (depth [B,N,D,fH,fW], feat [B,N,fH,fW,C], vox_idx, valid, bev_size),
    the frustum over the BEV grid, softmaxed random depth, random
    context."""
    from ocrfdet_tpu_torch.entry import make_batch
    from ocrfdet_tpu_torch.geometry import frustum as FR

    batch = make_batch(cfg, seed=0, batch_size=B, device=dev)
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
    g = torch.Generator(device=dev).manual_seed(seed)
    depth = torch.randn((B, N, D, fH, fW), generator=g,
                        device=dev).softmax(2)
    feat = torch.randn((B, N, fH, fW, C), generator=g, device=dev)
    return depth, feat, vox, valid, (X, Y, 1)


def flagship_pool_inputs(cfg, dev, B, seed):
    """K2's point streams of `flagship_lss_inputs` (`lss_points`)."""
    from ocrfdet_tpu_torch.ops import bev_pool as bp

    return bp.lss_points(*flagship_lss_inputs(cfg, dev, B, seed))


def _k2_case(cfg, dev, B):
    """K2's forward at flagship shape, batch B: preparation (the sort into
    cell intervals) and kernel timed apart and together, run-to-run
    bitwise equality, the longest interval."""
    from ocrfdet_tpu_torch.ops import bev_pool as bp

    w, pix, cell, featp, cells = flagship_pool_inputs(cfg, dev, B, seed=1)
    C = featp.shape[-1]
    got = bp.bev_pool_points(w, pix, cell, featp, cells)
    again = bp.bev_pool_points(w, pix, cell, featp, cells)
    want = bp.bev_pool_points_plain(w, pix, cell, featp, cells)
    intervals = bp.cell_intervals(cell, cells)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    same = bool(torch.equal(got, again))
    # another fp32 sum order than index_add_'s: rtol 1e-5 / atol 1e-5
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5)) and same
    offsets = intervals[1]
    lengths = (offsets[1:] - offsets[:-1]).reshape(B, cells + 1)[:, :cells]
    longest = int(lengths.max())
    ms = device_ms(lambda: bp.bev_pool_points(w, pix, cell, featp, cells),
                   reps=50)
    prep_ms = device_ms(lambda: bp.cell_intervals(cell, cells), reps=50)
    kernel_ms = device_ms(lambda: bp.bev_pool_forward(
        w, pix, cell, featp, cells, *intervals), reps=50)
    plain_ms = device_ms(
        lambda: bp.bev_pool_points_plain(w, pix, cell, featp, cells), reps=10)
    # yardstick: one index_add_ of the precomputed weighted rows
    keep = cell < cells
    bidx = torch.arange(B, device=dev)[:, None].expand_as(cell)[keep]
    rows = featp[bidx, pix[keep].long()] * w[keep][:, None]
    idx = bidx * cells + cell[keep].long()
    acc = torch.zeros((B * cells, C), device=dev)
    library_ms = device_ms(lambda: acc.index_add_(0, idx, rows), reps=50)
    wk = work.bev_pool_work(w, pix, cell, featp, want, cells)
    n_valid, moved = wk["points"], wk["bytes"]
    bound_ms, bound_by = bound(moved, wk["flops"])
    log(f"[k2] bev_pool batch {B} {tuple(got.shape)}: max_abs_err "
        f"{max_abs:.3e} (tol rtol 1e-5 atol 1e-5), run to run "
        f"{'bitwise equal' if same else 'DIFFERENT'}: "
        f"{'ok' if ok else 'FAIL'}; preparation + kernel {ms:.4f} ms "
        f"(preparation {prep_ms:.4f} ms, kernel {kernel_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.2f} MB, {n_valid} "
        f"of {w.numel()} points in the grid, longest cell interval "
        f"{longest} points)")
    if not ok:
        raise AssertionError(f"K2 kernel disagrees with its plain version "
                             f"or with itself at batch {B}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                prep_ms=prep_ms, kernel_ms=kernel_ms)


def check_k2(cfg, dev):
    """K2's forward at batch 1 and 2."""
    b1, b2 = _k2_case(cfg, dev, 1), _k2_case(cfg, dev, 2)
    return with_b2(b1, b2, ("ms", "plain_ms", "bound_ms", "library_ms",
                            "prep_ms", "kernel_ms"))


def flagship_projection(cfg, dev, B=1):
    """The key frame's HT projection (uvd, valid) of make_batch."""
    from ocrfdet_tpu_torch.entry import make_batch
    from ocrfdet_tpu_torch.geometry import frustum as FR

    batch = make_batch(cfg, seed=0, batch_size=B, device=dev)
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


def k3_inputs(cfg, dev, B):
    """K3's forward inputs at flagship shape, batch B: the key frame's
    projection, thresholded softmax depth, random context, as
    `ht_pool_inputs` gives them (dep, ctx, pix, di, wv)."""
    from ocrfdet_tpu_torch.ops import ht_pool as htp

    uvd, valid = flagship_projection(cfg, dev, B)
    N, D, C = cfg.data.num_cams, cfg.grid.num_depth_bins, cfg.vt.out_channels
    h = cfg.data.input_size[0] // cfg.vt.downsample
    w = cfg.data.input_size[1] // cfg.vt.downsample
    g = torch.Generator(device=dev).manual_seed(2)
    depth = torch.randn((B, N, h, w, D), generator=g, device=dev).softmax(-1)
    depth = torch.where(depth < cfg.vt.depth_threshold / D,
                        torch.zeros_like(depth), depth)
    ctx = torch.randn((B, N, h, w, C), generator=g, device=dev)
    return htp.ht_pool_inputs(depth, ctx, uvd, valid)


def k3_library(dep, ctx, pix, di, wv):
    """K3's function as one PyTorch call, F.embedding_bag(mode="sum")
    over ctx as [B*N*HW, C] rows, a bag per pillar with its points in
    [n][z] order, weighted by wv x dep[pix, di] from one torch.gather.
    Returns a closure (the index rearrangement built outside it)."""
    import torch.nn.functional as F

    B, N, HW, D = dep.shape
    C = ctx.shape[-1]
    Zh, Nq = pix.shape[2:]
    bn = torch.arange(B * N, device=dep.device).reshape(B, N, 1, 1)
    rows = bn * HW + pix.long()                     # [B, N, Zh, Nq]

    def bags(x):                                    # -> [B*Nq, N*Zh]
        return x.permute(0, 3, 1, 2).reshape(B * Nq, N * Zh).contiguous()
    rows_b, wv_b = bags(rows), bags(wv)
    dep_b = bags(rows * D + di.long())
    dep_flat, ctx_flat = dep.reshape(-1), ctx.reshape(-1, C)

    def library():
        psw = torch.gather(dep_flat, 0, dep_b.reshape(-1)).reshape(
            dep_b.shape) * wv_b
        return F.embedding_bag(rows_b, ctx_flat, mode="sum",
                               per_sample_weights=psw)
    return library


def _k3_case(cfg, dev, B):
    """K3 at flagship shape, batch B, against its plain version and
    F.embedding_bag; the index bytes it stages and the valid points a
    pillar."""
    from ocrfdet_tpu_torch.ops import ht_pool as htp

    args = k3_inputs(cfg, dev, B)
    got = htp.ht_pool_points(*args)
    again = htp.ht_pool_points(*args)
    want = htp.ht_pool_points_plain(*args)
    library = k3_library(*args)
    lib = library().reshape(want.shape)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    scale = float(want.abs().max())
    same = bool(torch.equal(got, again))
    # the plain version sums the heights in its own order: rtol 1e-5,
    # atol 1e-5 of the output scale; so does embedding_bag
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale))
    lib_err = float((lib - want).abs().max())
    lib_ok = bool(torch.allclose(lib, want, rtol=1e-5, atol=1e-5 * scale))
    ms = device_ms(lambda: htp.ht_pool_points(*args), reps=50)
    plain_ms = device_ms(lambda: htp.ht_pool_points_plain(*args), reps=5)
    library_ms = device_ms(library, reps=20)
    wk = work.ht_pool_work(*args, want)
    n_valid, moved = wk["points"], wk["bytes"]
    C, pillars = args[1].shape[-1], B * args[2].shape[3]
    staged = nbytes(*args[2:])
    bound_ms, bound_by = bound(moved, wk["flops"])
    log(f"[k3] ht_pool batch {B} {tuple(got.shape)}: max_abs_err "
        f"{max_abs:.3e} (max |out| {scale:.3f}; tol rtol 1e-5 atol 1e-5 x "
        f"scale), run to run {'bitwise equal' if same else 'DIFFERENT'}: "
        f"{'ok' if ok and same else 'FAIL'}; embedding_bag max_abs_err "
        f"{lib_err:.3e} ({'ok' if lib_ok else 'FAIL'}); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, gather + embedding_bag {library_ms:.4f} "
        f"ms; bound {bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.2f} MB; "
        f"index bytes staged {staged / 1e6:.2f} MB; {n_valid} of "
        f"{args[4].numel()} points valid, {n_valid / pillars:.2f} of "
        f"{args[4].numel() // pillars} a pillar)")
    if not (ok and same and lib_ok):
        raise AssertionError(f"K3 kernel disagrees with its plain version "
                             f"or with itself, or embedding_bag with the "
                             f"plain version, at batch {B}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def check_k3(cfg, dev):
    """K3's forward at batch 1 and 2."""
    return with_b2(_k3_case(cfg, dev, 1), _k3_case(cfg, dev, 2))


def k4_inputs(cfg, dev, B, C):
    """K4's inputs at flagship shape: random maps at full image resolution
    of B x 6 cameras with C channels (1 at eval; the training step's key
    frame samples 4: alpha and RGB) and the key frame's projected points
    (px, py [B x 6, P])."""
    uvd, _ = flagship_projection(cfg, dev, B)
    N = cfg.data.num_cams
    H, W = cfg.vt.render_image_size
    P = uvd.shape[2] * uvd.shape[3]
    g = torch.Generator(device=dev).manual_seed(3)
    maps = torch.rand((B * N, H, W, C), generator=g, device=dev)
    px = (uvd[..., 0] * W).reshape(B * N, P).contiguous()
    py = (uvd[..., 1] * H).reshape(B * N, P).contiguous()
    return maps, px, py


def _k4_case(cfg, dev, B, C):
    """K4's forward at flagship shape, batch B, C channels."""
    import torch.nn.functional as F
    from ocrfdet_tpu_torch.ops import point_sample as ps

    maps, px, py = k4_inputs(cfg, dev, B, C)
    H, W = maps.shape[1:3]
    got = ps.point_sample_points(maps, px, py)
    want = ps.point_sample_points_plain(maps, px, py)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    # the same separately rounded products and sums: bit for bit
    ok = bool(torch.equal(got, want))
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
    lib_err = float((library()[:, :, 0].permute(0, 2, 1) - got).abs().max())
    library_ms = device_ms(library, reps=50)
    wk = work.point_sample_work(maps, px, py, want)
    moved = wk["bytes"]
    bound_ms, bound_by = bound(moved, wk["flops"])
    log(f"[k4] point_sample batch {B} C={C} {tuple(got.shape)}: max_abs_err "
        f"{max_abs:.3e} (tol: bit for bit: {'ok' if ok else 'FAIL'}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample "
        f"{library_ms:.4f} ms (max |diff| to it {lib_err:.3e}); bound "
        f"{bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.2f} MB)")
    if not ok:
        raise AssertionError(f"K4 kernel disagrees with its plain version "
                             f"at batch {B}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def check_k4(cfg, dev):
    """K4's forward at eval's batch 1 (C = 1) and at the training key
    frame's batch 2 (C = 4)."""
    return with_b2(_k4_case(cfg, dev, 1, 1), _k4_case(cfg, dev, 2, 4))


def check_k2_bwd(cfg, dev, B=2):
    """K2's backward at the training step's shape (batch B) on a random
    cotangent, vs the plain version's autograd, by both ways of naming a
    pixel's points: the LSS layout (the model's path, timed as the
    kernel's time) and the points sorted by pixel (the kernel timed apart
    from its sort); each the same bits on two runs, and the two the same
    bits as each other."""
    from ocrfdet_tpu_torch.ops import bev_pool as bp

    w, pix, cell, featp, cells = flagship_pool_inputs(cfg, dev, B, seed=11)
    P = w.shape[1]
    npix, C = featp.shape[1:]
    N = cfg.data.num_cams
    layout = (N, P // npix, npix // N)
    gen = torch.Generator(device=dev).manual_seed(12)
    cot = torch.randn((B, cells, C), generator=gen, device=dev)

    def lss():
        return bp.bev_pool_points_backward(w, pix, cell, featp, cot, cells,
                                           layout=layout)

    def by_pixel():
        return bp.bev_pool_points_backward(w, pix, cell, featp, cot, cells)
    got = {"lss": (lss(), lss()), "sorted": (by_pixel(), by_pixel())}
    (pw, pfeat), again = plain_grads(bp.bev_pool_points_plain,
                                     (w, pix, cell, featp, cells), (0, 3),
                                     cot)
    torch.cuda.synchronize()
    # another fp32 sum order than the plain autograd's: rtol 1e-5, atol
    # 1e-5 of each scale
    errs, ok = {}, True
    for path, (first, second) in got.items():
        (e1, s1, ok1), (e2, s2, ok2) = (close(first[0], pw, 1e-5, 1e-5),
                                        close(first[1], pfeat, 1e-5, 1e-5))
        same = all(map(torch.equal, first, second))
        errs[path] = (e1, e2, same)
        ok = ok and ok1 and ok2 and same
    paths_same = all(map(torch.equal, got["lss"][0], got["sorted"][0]))
    ok = ok and paths_same
    ms = device_ms(lss, reps=20)
    intervals = bp.cell_intervals(pix, npix)
    sort_ms = device_ms(lambda: bp.cell_intervals(pix, npix), reps=20)
    sorted_ms = device_ms(lambda: bp.bev_pool_backward(
        w, cell, featp, cot, cells, intervals=intervals), reps=20)
    plain_ms = device_ms(again, reps=5)
    # yardstick: index_add_ of the precomputed weighted rows of g into
    # dfeat plus one gather of the feature rows (the dw dot products are
    # not in it)
    keep = cell < cells
    bidx = torch.arange(B, device=dev)[:, None].expand_as(cell)[keep]
    rows = cot[bidx, cell[keep].long()] * w[keep][:, None]
    pidx = (bidx * npix + pix[keep].long())
    acc = torch.zeros((B * npix, C), device=dev)
    flat = featp.reshape(-1, C)
    gidx = pidx[:, None].expand(-1, C)
    library_ms = (device_ms(lambda: acc.index_add_(0, pidx, rows), reps=20)
                  + device_ms(lambda: torch.gather(flat, 0, gidx), reps=20))
    dw, dfeat = got["lss"][0]
    # the timed LSS path names a pixel's points in closed form: pix is
    # never read, so its bytes are not in the bound
    wk = work.bev_pool_backward_work(w, cell, featp, cot, dw, dfeat, cells)
    n_valid, moved = wk["points"], wk["bytes"]
    bound_ms, bound_by = bound(moved, wk["flops"])
    log(f"[k2-bwd] bev_pool backward g {tuple(cot.shape)} -> dw "
        f"{tuple(dw.shape)}, dfeat {tuple(dfeat.shape)}: "
        + "; ".join(f"{path}: max_abs_err dw {e1:.3e} (max {pw.abs().max():.3f}),"
                    f" dfeat {e2:.3e} (max {pfeat.abs().max():.3f}), run to "
                    f"run {'bitwise equal' if same else 'DIFFERENT'}"
                    for path, (e1, e2, same) in errs.items())
        + f"; the two paths {'bitwise equal' if paths_same else 'DIFFERENT'}"
        f" (tol rtol 1e-5 atol 1e-5 x scale): {'ok' if ok else 'FAIL'}; "
        f"kernel (LSS layout) {ms:.4f} ms, kernel by sorted pixel "
        f"{sorted_ms:.4f} ms + its sort {sort_ms:.4f} ms, plain (autograd) "
        f"{plain_ms:.4f} ms, index_add_ + gather {library_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.2f} MB, {n_valid} "
        f"of {w.numel()} points in the grid)")
    if not ok:
        raise AssertionError("K2 backward kernel disagrees with its plain "
                             "version, with itself or across its two "
                             "index paths")
    return dict(max_abs_err=max(max(e[:2]) for e in errs.values()), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, sorted_ms=sorted_ms,
                sort_ms=sort_ms)


def k3_bwd_inputs(cfg, dev, B=2):
    """K3's backward inputs at the training step's shape (batch 2: the
    key frame's projection for both samples): (dep, ctx, pix, di, wv) as
    `ht_pool_inputs` gives them, and a random cotangent [B, Nq, C]."""
    from ocrfdet_tpu_torch.ops import ht_pool as htp

    uvd, valid = flagship_projection(cfg, dev)
    uvd, valid = uvd.expand(B, *uvd.shape[1:]), valid.expand(
        B, *valid.shape[1:])
    N, D, C = cfg.data.num_cams, cfg.grid.num_depth_bins, cfg.vt.out_channels
    h = cfg.data.input_size[0] // cfg.vt.downsample
    w = cfg.data.input_size[1] // cfg.vt.downsample
    gen = torch.Generator(device=dev).manual_seed(13)
    depth = torch.randn((B, N, h, w, D), generator=gen,
                        device=dev).softmax(-1)
    depth = torch.where(depth < cfg.vt.depth_threshold / D,
                        torch.zeros_like(depth), depth)
    ctx = torch.randn((B, N, h, w, C), generator=gen, device=dev)
    args = htp.ht_pool_inputs(depth, ctx, uvd, valid)
    cot = torch.randn((B, args[2].shape[3], C), generator=gen, device=dev)
    return args, cot


def check_k3_bwd(cfg, dev, B=2):
    """K3's backward at the training step's shape (batch 2: the key
    frame's projection for both samples) on a random cotangent: the
    ordering (equal to its plain version), the kernel (the same bits on
    two runs), timed apart and together, and the longest row."""
    from ocrfdet_tpu_torch.ops import ht_pool as htp

    args, cot = k3_bwd_inputs(cfg, dev, B)
    dep, ctxf, pix, di, wv = args
    Zh, Nq = pix.shape[2:]
    D, C, hw = dep.shape[-1], ctxf.shape[-1], dep.shape[2]
    ddep, dctx = htp.ht_pool_points_backward(*args, cot)
    again = htp.ht_pool_points_backward(*args, cot)
    ends, order = htp.ht_pool_order(pix, di, wv, hw, D)
    pends, porder = htp.ht_pool_order_plain(pix, di, wv, hw, D)
    (pdep, pctx), plain_again = plain_grads(htp.ht_pool_points_plain, args,
                                            (0, 1), cot)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip((ddep, dctx), again))
    ordered = bool(torch.equal(ends, pends)) and bool(
        torch.equal(order[:porder.numel()], porder))
    (e1, s1, ok1), (e2, s2, ok2) = (close(ddep, pdep, 1e-5, 1e-5),
                                    close(dctx, pctx, 1e-5, 1e-5))
    lengths = torch.diff(pends, prepend=pends.new_zeros(1))
    longest, hit = int(lengths.max()), int((lengths > 0).sum())
    ms = device_ms(lambda: htp.ht_pool_points_backward(*args, cot), reps=20)
    prep_ms = device_ms(lambda: htp.ht_pool_order(pix, di, wv, hw, D),
                        reps=20)
    kernel_ms = device_ms(lambda: htp.ht_pool_backward_ordered(
        dep, ctxf, wv, cot, ends, order, Zh, Nq), reps=20)
    parts = device_ms_by_kernel(
        lambda: htp.ht_pool_order(pix, di, wv, hw, D), reps=20)
    plain_ms = device_ms(plain_again, reps=5)
    wk = work.ht_pool_backward_work(*args, cot, ddep, dctx)
    n_valid, moved = wk["points"], wk["bytes"]
    bound_ms, bound_by = bound(moved, wk["flops"])
    ok = ok1 and ok2 and same and ordered
    log(f"[k3-bwd] ht_pool backward dout {tuple(cot.shape)} -> ddep "
        f"{tuple(ddep.shape)}, dctx {tuple(dctx.shape)}: max_abs_err ddep "
        f"{e1:.3e} (max {s1:.3f}), dctx {e2:.3e} (max {s2:.3f}) (tol rtol "
        f"1e-5 atol 1e-5 x scale), run to run "
        f"{'bitwise equal' if same else 'DIFFERENT'}, ordering "
        f"{'equal to' if ordered else 'DIFFERENT from'} its plain version: "
        f"{'ok' if ok else 'FAIL'}; ordering + kernel {ms:.4f} ms "
        f"(ordering {prep_ms:.4f} ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"; kernel {kernel_ms:.4f} ms), plain "
        f"(autograd) {plain_ms:.4f} ms, no library call; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.2f} MB, {n_valid} "
        f"of {wv.numel()} points valid, {hit} of {lengths.numel()} rows "
        f"hit, longest row {longest} points)")
    if not ok:
        raise AssertionError("K3 backward kernel disagrees with its plain "
                             "version or with itself")
    return dict(max_abs_err=max(e1, e2), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                prep_ms=prep_ms, kernel_ms=kernel_ms, longest_row=longest)


def events_ms(fn, reps: int) -> float:
    """Mean time per call of fn() from CUDA events around `reps`
    back-to-back calls after one warm-up call (each call's device work
    must outlast its launch for this to time the device)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_k4_bwd(cfg, dev, B=2):
    """K4's backward at the training step's shape: C = 4 maps ([alpha,
    RGB]) of B x 6 cameras at full resolution, a random cotangent. The
    binning holds the plain version's keys in each bin; dmap has the bits
    of the plain walk in the kernel's order, the same bits on two runs,
    and is within rtol 1e-5 of the plain autograd. The backward, its
    binning and its kernel are timed apart, each by three traces and by
    CUDA events. Returns the backward's stats and the binning's."""
    import torch.nn.functional as F
    from ocrfdet_tpu_torch.ops import point_sample as ps

    uvd, _ = flagship_projection(cfg, dev)
    N, C = cfg.data.num_cams, 4
    H, W = cfg.vt.render_image_size
    P = uvd.shape[2] * uvd.shape[3]
    px = (uvd[0, ..., 0] * W).reshape(N, P).repeat(B, 1).contiguous()
    py = (uvd[0, ..., 1] * H).reshape(N, P).repeat(B, 1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(14)
    maps = torch.rand((B * N, H, W, C), generator=gen, device=dev)
    cot = torch.randn((B * N, P, C), generator=gen, device=dev)

    def run():
        return ps.point_sample_points_backward(px, py, cot, maps.shape)

    def order():
        return ps.point_sample_order(px, py, H, W)
    spans, placed = order()
    dmap, again = run(), run()
    walk = ps.point_sample_backward_walk_plain(px, py, cot, maps.shape)
    pends, porder = ps.point_sample_order_plain(px, py, H, W)
    (pmap,), plain_again = plain_grads(ps.point_sample_points_plain,
                                       (maps, px, py), (0,), cot)
    torch.cuda.synchronize()
    err, scale, ok = close(dmap, pmap, 1e-5, 1e-5)
    same, bits = bool(torch.equal(dmap, again)), bool(torch.equal(dmap, walk))
    binned = bool(torch.equal(torch.cumsum(spans[1] - spans[0], 0), pends)
                  ) and bool(torch.equal(ps.binned_keys(spans, placed),
                                         porder))
    lengths = spans[1] - spans[0]

    def kernel():
        return ps.point_sample_backward_ordered(px, py, cot, spans, placed,
                                                maps.shape)
    times = {}
    for name, fn in (("backward", run), ("binning", order),
                     ("kernel", kernel)):
        traces = device_ms_traces(fn, reps=20)
        times[name] = (float(np.median(traces)), traces,
                       events_ms(fn, reps=20))
    parts = device_ms_by_kernel(run, reps=20)
    plain_ms = device_ms(plain_again, reps=5)
    order_plain_ms = device_ms(
        lambda: ps.point_sample_order_plain(px, py, H, W), reps=5)
    # yardstick: F.grid_sample's backward to its input on the same points
    m_nchw = maps.permute(0, 3, 1, 2).contiguous().requires_grad_()
    grid = torch.stack([(2 * px + 1) / W - 1, (2 * py + 1) / H - 1],
                       -1)[:, None]
    out = F.grid_sample(m_nchw, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    cot_l = cot.permute(0, 2, 1)[:, :, None].contiguous()
    library_ms = device_ms(lambda: torch.autograd.grad(
        out, m_nchw, cot_l, retain_graph=True), reps=20)
    wk = work.point_sample_backward_work(px, py, cot, H, W)
    moved, n_in = wk["bytes"], wk["points"]
    bound_ms, bound_by = bound(moved, wk["flops"])
    all_dout = nbytes(px, py, cot, dmap)
    keys = int(lengths.sum())
    # the binning must read px and py and write each key once
    wk = work.point_sample_order_work(px, py, keys)
    order_bound_ms, order_bound_by = bound(wk["bytes"], wk["flops"])

    def span(name):
        med, traces, ev = times[name]
        return (f"{med:.4f} ms (three traces: "
                f"{', '.join(f'{x:.4f}' for x in traces)}; CUDA events "
                f"{ev:.4f})")
    log(f"[k4-bwd] point_sample backward dout {tuple(cot.shape)} -> dmap "
        f"{tuple(dmap.shape)}: max_abs_err {err:.3e} (max {scale:.3f}; tol "
        f"rtol 1e-5 atol 1e-5 x scale), run to run "
        f"{'bitwise equal' if same else 'DIFFERENT'}, the plain walk's "
        f"bits {'yes' if bits else 'NO'}, binning "
        f"{'equal to' if binned else 'DIFFERENT from'} its plain version: "
        f"{'ok' if ok and same and bits and binned else 'FAIL'}; backward "
        f"{span('backward')}: binning {span('binning')}, kernel "
        f"{span('kernel')}; by kernel: "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"; plain (autograd) {plain_ms:.4f} ms, plain binning "
        f"{order_plain_ms:.4f} ms, grid_sample backward {library_ms:.4f} "
        f"ms; bound {bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.2f} MB: "
        f"px, py, the dout rows of the {n_in} of {px.numel()} points with "
        f"a tap in the image in 32-byte sectors, dmap; with all of dout "
        f"{all_dout / 1e6:.2f} MB); binning bound {order_bound_ms:.4f} ms; "
        f"{keys} keys in {lengths.numel()} bins, "
        f"{int((lengths > 0).sum())} hit, the largest {int(lengths.max())}")
    if not (ok and same and bits and binned):
        raise AssertionError("K4 backward kernel disagrees with its plain "
                             "versions or with itself, or its binning with "
                             "its plain version")
    backward = dict(max_abs_err=err, ms=times["backward"][0],
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms, ms_traces=times["backward"][1],
                    ms_events=times["backward"][2],
                    prep_ms=times["binning"][0],
                    prep_ms_events=times["binning"][2],
                    kernel_ms=times["kernel"][0],
                    kernel_ms_events=times["kernel"][2])
    binning = dict(max_abs_err=0.0, ms=times["binning"][0],
                   plain_ms=order_plain_ms, bound_ms=order_bound_ms,
                   bound_by=order_bound_by, library_ms=None,
                   ms_events=times["binning"][2])
    return backward, binning


def sass_mufu(kernel, function: str) -> dict:
    """{MUFU operation: count} in the compiled code (`cuobjdump -sass` of
    the built library) of the device function whose name holds
    `function`: its main body (up to its last unconditional EXIT; the
    subroutines after it are slow paths), without the reciprocals that
    seed an integer division (MUFU.RCP of an I2F result)."""
    import re
    from pathlib import Path
    from ocrfdet_tpu_torch import kernels
    tool = Path(kernels.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(kernel.library_path())],
                          capture_output=True, text=True, check=True).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function in line
        elif inside:
            m = re.search(r"\*/\s+(.*?)\s*;", line)
            if m:
                body.append(m.group(1))
    exits = [i for i, ins in enumerate(body) if ins == "EXIT"]
    counts = {}
    for i, ins in enumerate(body[:exits[-1]] if exits else []):
        m = re.match(r"(?:@!?U?P\w+\s+)?MUFU\.(\w+)\s+R\d+,\s*(R\d+)", ins)
        if m and not (m.group(1) == "RCP" and any(
                re.match(rf"I2F\S*\s+{m.group(2)}\b", prev)
                for prev in body[max(0, i - 4):i])):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    if not counts.get("EX2"):
        raise AssertionError(f"no MUFU.EX2 (exp) in the SASS of {function}")
    return counts


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


H100_SMS = 132
MUFU_PER_SM_CLOCK = 16          # special-function results per SM a clock
ISSUE_PER_SM_CLOCK = 4          # warp-instructions issued per SM a clock


def check_k5(attrs, T, n_tx):
    """K5 forward and backward on the flagship streams recorded in the
    training window (both samples' tiles, as the step launches them),
    with random cotangents, vs the plain version; forward and backward
    twice (the same bits)."""
    from ocrfdet_tpu_torch.ops.splat import composite as ct

    dev = attrs.device
    rgb, med, logt, cross = ct.composite_forward(attrs, T, n_tx, 16)
    fwd_same = all(torch.equal(x, y) for x, y in zip(
        (rgb, med, logt, cross), ct.composite_forward(attrs, T, n_tx, 16)))
    prgb, pmed, plogt, pcross = ct.composite_forward_plain(attrs, T, n_tx,
                                                           16, 16)
    gen = torch.Generator(device=dev).manual_seed(15)
    g_rgb = torch.randn(rgb.shape, generator=gen, device=dev)
    g_med = torch.randn(med.shape, generator=gen, device=dev)
    g_logt = torch.randn(logt.shape, generator=gen, device=dev)
    bwd_args = (attrs, prgb, g_rgb, g_logt, g_med, pcross, T, n_tx, 16)
    d = ct.composite_backward(*bwd_args)
    same = bool(torch.equal(d, ct.composite_backward(*bwd_args)))
    pd = ct.composite_backward_plain(*bwd_args[:-1], 16, 16)
    torch.cuda.synchronize()
    # the same chunks, other sums inside a chunk: rtol 1e-4, atol 1e-5 of
    # the scale (the Pallas kernel's tolerance against the XLA
    # compositor); the median may differ where T crosses 0.5 within
    # rounding (at most 1 pixel in 10^4)
    fwd = [close(rgb, prgb, 1e-4, 1e-5), close(logt, plogt, 1e-4, 1e-5)]
    flips = int((med - pmed).abs().gt(1e-5 * pmed.abs()).sum())
    cross_flips = int((cross != pcross).sum())
    fwd_ok = (all(ok for *_, ok in fwd) and fwd_same
              and max(flips, cross_flips) <= med.numel() // 10000)
    bwd = {k: close(d[..., i], pd[..., i], 1e-4, 1e-5)
           for i, k in enumerate(ct.STREAMS)}
    bwd_ok = all(ok for *_, ok in bwd.values())
    cw = work.composite_work(attrs, T, n_tx)
    live, kept = cw["live"], cw["kept"]
    pairs = live * ct.TILE_PIXELS
    steps = live * (ct.TILE_PIXELS // 32)      # (warp, live Gaussian)
    fwd_ms = device_ms(lambda: ct.composite_forward(attrs, T, n_tx, 16),
                       reps=20)
    bwd_ms = device_ms(lambda: ct.composite_backward(*bwd_args), reps=10)
    fwd_plain = device_ms(lambda: ct.composite_forward_plain(
        attrs, T, n_tx, 16, 16), reps=2)
    bwd_plain = device_ms(lambda: ct.composite_backward_plain(
        *bwd_args[:-1], 16, 16), reps=2)
    # operations: ops/work.py's composite_{forward,backward}_work. Special
    # functions (16 results a clock per SM at the card's maximum clock):
    # what the function needs on these streams, one exp per pair inside
    # its Gaussian's square (the only pairs that need it), then forward
    # one log per pixel (log T, T kept as a product) and backward one
    # reciprocal of 1 - alpha per kept pair (the suffix trick). The
    # compiled code's MUFU instructions are printed beside it.
    clock = max_sm_clock_hz()
    sfu_rate = H100_SMS * MUFU_PER_SM_CLOCK * clock
    sfu_fwd = cw["square"] + med.numel()
    sfu_bwd = cw["square"] + kept
    fw = work.composite_forward_work(attrs, rgb, med, logt, cw)
    bw = work.composite_backward_work(attrs, prgb, g_rgb, g_logt, g_med, d,
                                      cw)
    fb_ops = bound(fw["bytes"], fw["flops"])
    bb_ops = bound(bw["bytes"], bw["flops"])
    mufu = {name: sass_mufu(k, fn) for name, k, fn in (
        ("forward", ct.KERNEL, "composite_forward_kernel"),
        ("backward", ct.BWD_KERNEL, "composite_backward_kernel"))}

    def with_sfu(ops_bound, results):
        """(ms, bound_by, the term that sets it)"""
        sfu_ms = results / sfu_rate * 1e3
        if sfu_ms > ops_bound[0]:
            return sfu_ms, "operations", "special functions"
        return (*ops_bound, "fp32" if ops_bound[1] == "operations"
                else ops_bound[1])
    fb, bb = with_sfu(fb_ops, sfu_fwd), with_sfu(bb_ops, sfu_bwd)
    # an estimate, not a measurement: the issue slots the measured time
    # holds at the maximum clock (the clock the card ran at is not read)
    issue, fwd_issue = (x * 1e-3 * H100_SMS * ISSUE_PER_SM_CLOCK * clock
                        / steps for x in (bwd_ms, fwd_ms))
    worst = max(bwd, key=lambda k: bwd[k][0] / bwd[k][1])
    log(f"[k5] composite_tiles attrs {tuple(attrs.shape)} ({live} live "
        f"slots; of their {pairs} pixel-Gaussian pairs {cw['square']} "
        f"inside the 3-sigma square, {kept} kept): forward max_abs_err rgb "
        f"{fwd[0][0]:.3e} (max {fwd[0][1]:.3f}), logt {fwd[1][0]:.3e} (max "
        f"{fwd[1][1]:.3f}), median flips {flips}, crossing-slot flips "
        f"{cross_flips} of {med.numel()}, run to run "
        f"{'bitwise equal' if fwd_same else 'DIFFERENT'} (tol rtol 1e-4 "
        f"atol 1e-5 x scale, flips <= 1e-4, the same bits: "
        f"{'ok' if fwd_ok else 'FAIL'}); backward worst {worst} "
        f"{bwd[worst][0]:.3e} (max {bwd[worst][1]:.3e}) (tol rtol 1e-4 atol "
        f"1e-5 x scale per stream: {'ok' if bwd_ok else 'FAIL'}), run to "
        f"run {'bitwise equal' if same else 'DIFFERENT'}"
        f"; forward kernel {fwd_ms:.4f} ms, plain {fwd_plain:.3f} ms, "
        f"bound {fb[0]:.4f} ms by {fb[2]}; backward kernel {bwd_ms:.4f} "
        f"ms, plain {bwd_plain:.3f} ms, bound {bb[0]:.4f} ms by {bb[2]}; "
        f"no library call")
    log(f"[k5] bound terms: special functions forward "
        f"{sfu_fwd / sfu_rate * 1e3:.4f} ms ({sfu_fwd} results), backward "
        f"{sfu_bwd / sfu_rate * 1e3:.4f} ms ({sfu_bwd} results) at "
        f"{clock / 1e6:.0f} MHz; fp32 operations forward {fb_ops[0]:.4f} "
        f"ms, backward {bb_ops[0]:.4f} ms; MUFU in the compiled code: forward "
        f"{mufu['forward']}, backward {mufu['backward']}; "
        f"{steps} (warp of 32 pixels, live Gaussian) steps, an estimated "
        f"{fwd_issue:.1f} (forward) and {issue:.1f} (backward) issue slots "
        f"per step (the measured time x {H100_SMS} SMs x "
        f"{ISSUE_PER_SM_CLOCK} a clock at the assumed {clock / 1e6:.0f} "
        f"MHz)")
    for k, (e, s, ok) in bwd.items():
        log(f"[k5]   d{k}: max_abs_err {e:.3e}, max {s:.3e}"
            f"{'' if ok else ' FAIL'}")
    if not (fwd_ok and bwd_ok and same):
        raise AssertionError("K5 kernel disagrees with its plain version "
                             "or with itself")
    fwd_err = max(fwd[0][0], fwd[1][0])
    return (dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain,
                 bound_ms=fb[0], bound_by=fb[1], library_ms=None),
            dict(max_abs_err=max(e for e, _, _ in bwd.values()), ms=bwd_ms,
                 plain_ms=bwd_plain, bound_ms=bb[0], bound_by=bb[1],
                 library_ms=None))


@contextlib.contextmanager
def recording_kernel_inputs():
    """Record a call of each model-level kernel wrapper (K1-K5,
    `_kernel_entries`), the first that is differentiated (the key
    frame's) where there is one: yields {name: (arguments, which of
    them require grad)}."""
    recorded = {}
    with contextlib.ExitStack() as stack:
        for name, (mod, attr, _) in _kernel_entries().items():
            def record(*args, _f=getattr(mod, attr), _name=name):
                req = [torch.is_tensor(a) and a.requires_grad for a in args]
                if _name not in recorded or (any(req) and not any(
                        recorded[_name][1])):
                    recorded[_name] = (
                        [a.detach().clone() if torch.is_tensor(a) else a
                         for a in args], req)
                return _f(*args)
            stack.enter_context(mock.patch.object(mod, attr, record))
        yield recorded


def check_training(dev, all_kernels, per_step, n_steps=10, n_warmup=3):
    """The main path: flagship training steps at batch 2 through
    `entry.train_step`. Every kernel's count is set to 0 just before the
    timed window and read just after: each must have launched exactly
    per_step[kernel] times per step. Returns (launches, the kernels'
    inputs recorded in the first warm-up step: `recording_kernel_inputs`;
    K5's are its streams and their tiling)."""
    from ocrfdet_tpu_torch import bench_train, entry
    from ocrfdet_tpu_torch.config import ocrfdet_config

    cfg = ocrfdet_config(batch_size=2)
    t0 = time.perf_counter()
    state = entry.build_trainer(cfg, dev, seed=0)
    batches = [entry.make_batch(cfg, seed=s, batch_size=2, device=dev,
                                with_targets=True) for s in range(2)]
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"[train] built the flagship trainer ({n_params / 1e6:.2f} M params, "
        f"{cfg.compute_dtype} towers, remat={cfg.backbone.remat}) and 2 "
        f"training batches of 2 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with recording_kernel_inputs() as recorded:
        first = entry.train_step(state, batches[0])
    for i in range(1, n_warmup):
        entry.train_step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    log(f"[train] {n_warmup} warm-up steps in {time.perf_counter() - t0:.1f}"
        f" s (first loss_total {first['loss_total']:.4f})")
    for k in all_kernels:
        k.launches = 0
    r = bench_train.window(state, batches, n_steps)
    launches = {k.name: k.launches for k in all_kernels}
    for k in all_kernels:
        want = per_step.get(k.name, 0) * n_steps
        if launches[k.name] != want:
            raise AssertionError(f"{k.name}: {launches[k.name]} launches over "
                                 f"{n_steps} training steps, expected {want}")
    m = r["metrics"]
    bad = [k for k, v in m.items() if not np.isfinite(v)]
    if bad or r["skipped"] or state.step != n_warmup + n_steps:
        raise AssertionError(f"training window: non-finite {bad}, "
                             f"{r['skipped']} skipped, step {state.step}")
    log(f"[train] {n_steps} steps after {n_warmup} warm-up (batch 2, "
        f"{cfg.total_frames} frames x {cfg.data.num_cams} cams at "
        f"{cfg.data.input_size}, {cfg.compute_dtype}) in a "
        f"{r['wall_s']:.3f} s window: {r['frames_per_s']:.3f} frames/s; step "
        f"ms median {r['step_ms_median']:.3f} p90 {r['step_ms_p90']:.3f}; "
        f"peak device memory {r['peak_mem_gb']:.2f} GB; skipped_nonfinite "
        f"{r['skipped']:.0f}; launches {launches}")
    log(f"[train] last step's losses: " + json.dumps(
        {k: round(v, 6) for k, v in m.items()}))
    return launches, recorded


def check_kernels_b4(cfg, dev):
    """K1, K2-K4 forward and K2-K4 backward at the GeoEnhDet training
    step's batch 4 (`geoenh_config()`: its kernels' shapes are the
    flagship's but for the batch), each against its plain version with
    the tolerances of the batch-1 and batch-2 cases. {name: stats}."""
    out = {"cost_volume": _k1_case(cfg, dev, 4),
           "bev_pool": _k2_case(cfg, dev, 4),
           "ht_pool": _k3_case(cfg, dev, 4),
           "point_sample": _k4_case(cfg, dev, 4, 4),
           "bev_pool_bwd": check_k2_bwd(cfg, dev, B=4),
           "ht_pool_bwd": check_k3_bwd(cfg, dev, B=4)}
    out["point_sample_bwd"], _ = check_k4_bwd(cfg, dev, B=4)
    check_k1_timing(cfg, dev)
    return out


def check_k1_timing(cfg, dev):
    """K1 at batch 1, 2 and 4 (`k1_inputs`) timed two ways on the same
    back-to-back calls: CUDA events around 20 calls, before and after the
    median of three torch.profiler traces of 20 calls (each kernel time
    of this script). K1 runs a millisecond or more a call, far longer
    than its launch, so the events time the device too; the two agree
    unless the traces are at fault."""
    from ocrfdet_tpu_torch.ops import cost_volume as cvm

    for B in (1, 2, 4):
        args = k1_inputs(cfg, dev, B)

        def fn():
            return cvm.cost_volume(*args)
        before = events_ms(fn, reps=20)
        traces = device_ms_traces(fn, reps=20)
        after = events_ms(fn, reps=20)
        log(f"[k1-timing] cost_volume batch {B}: profiler median "
            f"{float(np.median(traces)):.4f} ms (traces "
            f"{', '.join(f'{t:.4f}' for t in traces)}); CUDA events "
            f"{before:.4f} ms before, {after:.4f} ms after")
        del args


def _ranged(name, fn, events):
    """fn inside a torch.profiler range `name`, with CUDA events around
    it appended to events[name]."""
    def f(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        with torch.profiler.record_function(name):
            out = fn(*args, **kwargs)
        end.record()
        events.setdefault(name, []).append((start, end))
        return out
    return f


def check_geoenh_training(dev, all_kernels, per_step, n_steps=5,
                          n_warmup=3):
    """GeoEnhDet's training step (`geoenh_config()`: batch 4, 6 x 256 x
    704, 512-channel FPN, the VGGT-1B teacher at 294 x 518 with seeded
    random weights, bf16 towers) through `entry.train_step`: `n_warmup`
    steps, then a window of `n_steps` timed steps with every kernel's
    count set to 0 just before it and read just after: exactly the
    flagship's `per_step` a step (the teacher and the aligner launch no
    kernel of the repository). Every loss finite (both KD losses), no
    step skipped; every teacher parameter bitwise equal to its value
    before the window, frozen, with no optimizer moments and no EMA
    copy. Then one traced step for the device time of the teacher and of
    the KD branch (forward; busy time and span, the span longer where
    the host falls behind), the relative RMS of the
    teacher's bf16 tokens against an fp32 run on the same pair, and one
    traced teacher forward's device time by kernel group."""
    from ocrfdet_tpu_torch import bench_train, entry
    from ocrfdet_tpu_torch.config import geoenh_config
    from ocrfdet_tpu_torch.models.view_transformer import towers_autocast

    cfg = geoenh_config()
    B = cfg.batch_size
    t0 = time.perf_counter()
    state = entry.build_trainer(cfg, dev, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = state.model

    def count(m):
        return sum(p.numel() for p in m.parameters())
    n_teacher, n_aligner = count(model.aggregator), count(model.aligner)
    n_student = count(model) - n_teacher - n_aligner
    batches = [entry.make_batch(cfg, seed=s, batch_size=B, device=dev,
                                with_targets=True) for s in range(2)]
    log(f"[geoenh] built the GeoEnhDet trainer in {build_s:.1f} s (seeded "
        f"init on the host and copy to the card): teacher "
        f"{n_teacher / 1e6:.2f} M params (frozen, {cfg.vggt_teacher.depth} "
        f"frame + global blocks, DINOv2 depth {cfg.vggt_teacher.vit_depth},"
        f" {cfg.vggt_teacher.image_size}), aligner {n_aligner / 1e6:.2f} M, "
        f"student {n_student / 1e6:.2f} M; {cfg.compute_dtype} towers, "
        f"FPN {cfg.vt.in_channels} channels")
    teacher = {n: p.detach().cpu()
               for n, p in model.aggregator.named_parameters()}
    t0 = time.perf_counter()
    for i in range(n_warmup):
        first = entry.train_step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    log(f"[geoenh] {n_warmup} warm-up steps in "
        f"{time.perf_counter() - t0:.1f} s (last loss_total "
        f"{first['loss_total']:.4f})")
    for k in all_kernels:
        k.launches = 0
    r = bench_train.window(state, batches, n_steps)
    launches = {k.name: k.launches for k in all_kernels}
    for k in all_kernels:
        want = per_step.get(k.name, 0) * n_steps
        if launches[k.name] != want:
            raise AssertionError(f"{k.name}: {launches[k.name]} launches over "
                                 f"{n_steps} GeoEnhDet steps, expected {want}")
    m = r["metrics"]
    bad = [k for k, v in m.items() if not np.isfinite(v)]
    kd = {k: m.get(k) for k in ("loss_Smoothl1_KD", "loss_cos_KD")}
    if bad or None in kd.values() or r["skipped"] \
            or state.step != n_warmup + n_steps:
        raise AssertionError(f"GeoEnhDet window: non-finite {bad}, KD "
                             f"{kd}, {r['skipped']} skipped, step "
                             f"{state.step}")
    changed = [n for n, p in model.aggregator.named_parameters()
               if not torch.equal(p.detach().cpu(), teacher[n])]
    frozen = set(state.optimizer.names["frozen"])
    in_optimizer = [k for k in state.optimizer.state_dict()
                    if k.split(".", 1)[1].startswith("aggregator.")]
    in_ema = [k for k in state.ema_params.names
              if k.startswith("aggregator.")]
    trainable = [n for n, p in model.aggregator.named_parameters()
                 if p.requires_grad or p.grad is not None]
    if changed or frozen != {"aggregator." + n for n in teacher} \
            or in_optimizer or in_ema or trainable:
        raise AssertionError(f"teacher: {len(changed)} tensors changed, "
                             f"{len(frozen)} frozen of {len(teacher)}, "
                             f"{len(in_optimizer)} optimizer moments, "
                             f"{len(in_ema)} EMA copies, {len(trainable)} "
                             f"trainable")
    del teacher
    log(f"[geoenh] {n_steps} steps after {n_warmup} warm-up (batch {B}, "
        f"{cfg.total_frames} frames x {cfg.data.num_cams} cams at "
        f"{cfg.data.input_size}) in a {r['wall_s']:.3f} s window: "
        f"{r['frames_per_s']:.3f} frames/s; step ms median "
        f"{r['step_ms_median']:.3f} p90 {r['step_ms_p90']:.3f}; peak device "
        f"memory {r['peak_mem_gb']:.2f} GB; skipped_nonfinite "
        f"{r['skipped']:.0f}; launches {launches} (the flagship's per step); "
        f"the teacher's {len(frozen)} tensors bitwise unchanged, frozen, no "
        f"optimizer moments, no EMA copy")
    log("[geoenh] last step's losses: " + json.dumps(
        {k: round(v, 6) for k, v in m.items()}))

    # one traced step: the teacher's and the KD branch's forward
    events = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with mock.patch.object(model.aggregator, "forward", _ranged(
            "geoenh.teacher", model.aggregator.forward, events)), \
            mock.patch.object(model, "kd_branch", _ranged(
                "geoenh.kd_branch", model.kd_branch, events)), \
            torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        entry.train_step(state, batches[0])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from ocrfdet_tpu_torch.profile_infer import busy_us, device_breakdown
    # the device's kernels, copies and memsets; the ranges' device-side
    # annotations span their gaps too
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in dev_events if _is_kernel(e)]
    step_busy = busy_us([(e.time_range.start, e.time_range.end)
                         for e in kernels]) / 1e3

    def on_device(name):
        """(busy, span) ms of a range on the device: the span of its
        device-side annotation and the union of the kernel intervals
        inside it; None where the trace holds no such annotation."""
        spans = [e.time_range for e in dev_events if e.name == name]
        if not spans:
            return None
        s, t = min(r.start for r in spans), max(r.end for r in spans)
        inside = [(max(e.time_range.start, s), min(e.time_range.end, t))
                  for e in kernels
                  if e.time_range.end > s and e.time_range.start < t]
        return busy_us(inside) / 1e3, (t - s) / 1e3
    teacher, kd = on_device("geoenh.teacher"), on_device("geoenh.kd_branch")
    ranges = ("not in the trace" if None in (teacher, kd) else
              f"teacher busy {teacher[0]:.3f} ms in a span of "
              f"{teacher[1]:.3f} ms; aligner, group-correlation volumes and "
              f"KD losses busy {kd[0] - teacher[0]:.3f} ms (the KD branch "
              f"{kd[0]:.3f} ms in a span of {kd[1]:.3f} ms)")
    ev = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()}
    log(f"[geoenh] one traced step ({wall_us / 1e3:.1f} ms with the "
        f"profiler; device busy {step_busy:.3f} ms, idle share "
        f"{1 - step_busy * 1e3 / wall_us:.3f}): forward on the device "
        f"(torch.profiler ranges): {ranges}; CUDA events: teacher "
        f"{ev['geoenh.teacher']:.3f} ms, KD branch "
        f"{ev['geoenh.kd_branch']:.3f} ms")

    # the teacher's bf16 tokens against an fp32 run on the same pair
    with torch.no_grad():
        x = model.teacher_images(batches[0])
        with towers_autocast(x.device, torch.bfloat16):
            t16, _ = model.aggregator(x.to(torch.bfloat16))
        t32, _ = model.aggregator(x)
    rel = float((t16.float() - t32).pow(2).mean().sqrt()
                / t32.pow(2).mean().sqrt())
    log(f"[geoenh] teacher tokens {tuple(t32.shape)}: bf16 (as the step "
        f"runs it) vs fp32 relative RMS {rel:.3e}")
    if not np.isfinite(rel):
        raise AssertionError("non-finite teacher tokens")
    del t16, t32

    # where the teacher's forward spends its device time, away from the
    # step's host-bound dispatch
    def teacher():
        with torch.no_grad(), towers_autocast(x.device, torch.bfloat16):
            return model.aggregator(x.to(torch.bfloat16))
    teacher()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        teacher()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    parts = device_breakdown(prof, 1, wall_us)
    log(f"[geoenh] one teacher forward alone: device busy "
        f"{parts['device_busy_ms']:.3f} ms over {parts['device_events']} "
        f"device events; by group (ms): " + ", ".join(
            f"{g} {t:.3f}" for g, t in parts["group_ms"].items())
        + "; largest kernels (ms): " + ", ".join(
            f"{k} {t:.3f}" for k, t in parts["top_kernels_ms"][:5]))


def _module_of(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "img_view_transformer" \
        else parts[0]


def check_fp32_step(dev, all_kernels):
    """One fp32 training step's losses and gradients at batch 1, from the
    same weights, batch and dropout masks, by several routes: every
    kernel (three times: every kernel, forward and backward, adds in a
    fixed order and the losses come out the same, but PyTorch's own
    operations still move the gradients from run to run; two more runs
    under `torch.use_deterministic_algorithms(True, warn_only=True)`
    and cuDNN's deterministic algorithms log whether they agree and the
    operations PyTorch names as having no deterministic implementation,
    such as F.grid_sample's backward in the deformable attention), every
    plain version (no kernel launched), K2-K5 plain
    with K1's kernel, each kernel alone plain, and K1's and K2's kernels
    jittered (`jittered`: a relative noise of one fp32 rounding on the
    output; K2's with three seeds). The three kernel runs set the
    runs-only floor, they and K2 jittered the noise floor."""
    from ocrfdet_tpu_torch import entry
    from ocrfdet_tpu_torch.config import ocrfdet_config
    from ocrfdet_tpu_torch.models.detector import OcRFDet
    from ocrfdet_tpu_torch.train.trainstep import compute_losses, total_loss
    from ocrfdet_tpu_torch.utils.weights import init_weights

    cfg = ocrfdet_config(batch_size=1, compute_dtype="float32")
    sd = init_weights(OcRFDet(cfg, render_heads=True), seed=0).state_dict()
    batch = entry.make_batch(cfg, seed=0, batch_size=1, device=dev,
                             with_targets=True)

    def step(route):
        model = OcRFDet(cfg, render_heads=True)
        model.load_state_dict(sd)
        model = model.to(dev).train()
        model.set_dropout_generator(
            torch.Generator(device=dev).manual_seed(5))
        before = [k.launches for k in all_kernels]
        with route:
            preds, aux = model(batch)
            losses = compute_losses(cfg, preds, aux, batch)
            total_loss(losses).backward()
        torch.cuda.synchronize()
        launched = sum(k.launches for k in all_kernels) - sum(before)
        grads = {n: p.grad.detach() for n, p in model.named_parameters()}
        return ({k: float(v.detach()) for k, v in losses.items()}, grads,
                launched)

    none = contextlib.nullcontext
    K, Ka, Kb = (step(none()) for _ in range(3))
    # what moves the kernels' runs apart: two more runs with PyTorch's
    # deterministic algorithms (cuDNN's too), which warn about the
    # operations that have none
    cudnn_deterministic = torch.backends.cudnn.deterministic
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            Kd = [step(none()) for _ in range(2)]
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = cudnn_deterministic
    no_det = set()
    for w in caught:
        msg = str(w.message)
        if "does not have a deterministic" in msg:
            no_det.add(msg.split(" does not have")[0])
        elif "CuBLAS" in msg:
            no_det.add("cuBLAS (CUBLAS_WORKSPACE_CONFIG unset)")
    P = step(plain_versions())
    S = step(plain_versions(only=KERNEL_NAMES[1:]))
    swap = {x: step(plain_versions(only=[x])) for x in KERNEL_NAMES}
    J1 = step(jittered("K1", dev))
    J2 = {seed: step(jittered("K2", dev, seed)) for seed in JITTER_SEEDS}
    if K[2] == 0 or P[2] != 0 or S[2] != 2:
        raise AssertionError(f"fp32 step: {K[2]} kernel launches with the "
                             f"kernels, {P[2]} with the plain versions, "
                             f"{S[2]} with K2-K5 plain (K1 twice expected)")
    names = sorted(P[1])
    flat_p = torch.cat([P[1][n].reshape(-1) for n in names])
    mods = sorted({_module_of(n) for n in names})
    mod_norm = {m: float(torch.cat([P[1][n].reshape(-1) for n in names
                                    if _module_of(n) == m]).norm())
                for m in mods}

    def diff(a, b):
        """(losses max rel err, gradient rel L2, {module: rel L2}, max abs
        gradient difference) of run a against run b, relative to the
        plain run's norms."""
        loss = max(abs(a[0][k] - b[0][k]) / max(abs(b[0][k]), 1e-6)
                   for k in b[0])
        d = {m: 0.0 for m in mods}
        mx = 0.0
        for n in names:
            e = a[1][n] - b[1][n]
            d[_module_of(n)] += float(e.norm()) ** 2
            mx = max(mx, float(e.abs().max()))
        grad = sum(d.values()) ** 0.5 / float(flat_p.norm())
        return (loss, grad, {m: v ** 0.5 / max(mod_norm[m], 1e-12)
                             for m, v in d.items()}, mx)

    def most(*ds):
        """Elementwise max of several diffs (the floor of repeated runs)."""
        return (max(d[0] for d in ds), max(d[1] for d in ds),
                {m: max(d[2][m] for d in ds) for m in mods},
                max(d[3] for d in ds))
    def identical(a, b):
        return a[0] == b[0] and all(torch.equal(a[1][n], b[1][n])
                                    for n in names)
    runs_same = identical(K, Ka) and identical(K, Kb)
    det_same = identical(*Kd)
    kr = most(diff(K, Ka), diff(K, Kb), diff(Ka, Kb))
    kj2 = {seed: diff(K, J) for seed, J in J2.items()}
    kk = most(kr, *kj2.values())
    ks, kp, kj = diff(K, S), diff(K, P), diff(K, J1)
    # the modules K2 does not feed: K2's jitter moves their gradients no
    # more than the kernels' runs do
    quiet = [m for m in mods
             if max(d[2][m] for d in kj2.values()) <= 3 * kr[2][m]]
    sw = {x: diff(K, swap[x]) for x in KERNEL_NAMES}

    def row(tag, d):
        worst = max(d[2], key=d[2].get)
        return (f"{tag}: losses {d[0]:.2e}, gradient {d[1]:.2e} (max abs "
                f"{d[3]:.2e}), height_w "
                f"{d[2]['img_view_transformer.height_w']:.2e}, worst module "
                f"{worst} {d[2][worst]:.2e}")
    log(f"[fp32-step] three runs of every kernel: losses and gradients "
        f"{'bitwise equal' if runs_same else 'DIFFERENT'}; two runs with "
        f"PyTorch's deterministic algorithms: "
        f"{'bitwise equal' if det_same else 'DIFFERENT'}, operations with "
        f"none: {', '.join(sorted(no_det)) or 'none'}")
    log(f"[fp32-step] batch 1, fp32, every kernel ({K[2]} launches) vs "
        f"other routes: max rel err of the losses, rel L2 of the gradient "
        f"(max |grad| {float(flat_p.abs().max()):.3e}): " + "; ".join(
            [row("kernels again and K2 jittered (floor)", kk),
             row("kernels again (runs-only floor)", kr),
             row("K2-K5 plain, K1 kernel", ks), row("all plain", kp),
             row("K1 jittered by one rounding", kj)]
            + [row(f"K2 jittered by one rounding, seed {seed}", d)
               for seed, d in kj2.items()]
            + [row(f"{x} alone plain", sw[x]) for x in KERNEL_NAMES]))
    log("[fp32-step] per-module gradient rel L2, K2-K5 plain with K1 "
        "kernel (floor; all plain; K1 jittered): " + ", ".join(
            f"{m} {ks[2][m]:.2e} ({kk[2][m]:.2e}; {kp[2][m]:.2e}; "
            f"{kj[2][m]:.2e})" for m in mods))
    log("[fp32-step] modules K2's jitter moves no more than the kernels' "
        "runs, held to the runs-only floor: K2-K5 plain with K1 kernel "
        "(runs-only floor): " + ", ".join(
            f"{m} {ks[2][m]:.2e} ({kr[2][m]:.2e})" for m in quiet))
    # tolerance: each kernel differs from its plain version by the order
    # of its fp32 sums. K1 (no backward; held against its plain version
    # at flagship shapes above) feeds the depth net, and this randomly
    # initialised train-mode model at batch 1 amplifies a difference of
    # one rounding at K1's output to about 1e-2 of the losses and 0.1 of
    # the gradient (K1 jittered). So the kernels of the training slice
    # (K2-K5, forward and backward), together and each alone, are held
    # with K1's kernel in both runs to the floor of three runs of the
    # kernels and of K2's output jittered by one rounding with three
    # seeds (the largest of their differences; K2's forward adds in a
    # fixed order, so the kernels' runs alone no longer show how far the
    # model carries one rounding of difference in the pooled features):
    # losses within 1e-4 or 3x the floor, the gradient within 3x the
    # floor plus 1e-3 of its norm. Per module (K2-K5 together) it is 3x
    # the floor plus 5e-2 of the module's norm: a few modules' gradients
    # (the NeRF alpha head `sigma`: 0.6-1.2% between runs of the same
    # kernels, up to 4% against K2-K5 plain) move by several times the
    # floor from call to call, while a mis-wired backward moves a
    # module's gradient by its own size. The modules that K2's jitter
    # does not move beyond the runs are held tighter, to 3x the runs-only
    # floor plus 1e-3 of the module's norm. K1 alone and all plain are
    # held to 3x what K1's jitter and the floor move together
    bad = []

    def within(tag, d, floor, modules=False):
        if d[0] > max(1e-4, 3 * floor[0]):
            bad.append(f"{tag} losses {d[0]:.2e}")
        if d[1] > 3 * floor[1] + 1e-3:
            bad.append(f"{tag} gradient {d[1]:.2e}")
        if modules:
            bad.extend(f"{tag} {m} {d[2][m]:.2e}" for m in mods
                       if d[2][m] > 3 * floor[2][m] + 5e-2)
    within("K2-K5 plain", ks, kk, modules=True)
    bad.extend(f"K2-K5 plain {m} {ks[2][m]:.2e} (runs-only floor)"
               for m in quiet if ks[2][m] > 3 * kr[2][m] + 1e-3)
    for x in KERNEL_NAMES[1:]:
        within(f"{x} alone plain", sw[x], kk)
    k1_floor = (kj[0] + kk[0], kj[1] + kk[1])
    within("K1 alone plain", sw["K1"], k1_floor)
    within("all plain", kp, k1_floor)
    if bad:
        raise AssertionError("fp32 step: kernels disagree with the plain "
                             "versions beyond the stated tolerance: "
                             + "; ".join(bad))


def _state_equal(a, b) -> list:
    """The keys where two `TrainState.state_dict()`s differ."""
    diff = [] if a["step"] == b["step"] else ["step"]
    if not torch.equal(a["generator"], b["generator"]):
        diff.append("generator")
    for part in ("model", "optimizer", "ema_params", "ema_stats"):
        if a[part].keys() != b[part].keys():
            diff.append(part)
            continue
        diff += [f"{part}.{k}" for k in a[part]
                 if not torch.equal(a[part][k], b[part][k])]
    return diff


def check_trainer(dev, all_kernels, eval_kernels, per_step, n_steps=2):
    """The trainer and the eval runner from a fake nuScenes on disk: a
    rendered train set (one scene of 8 samples) and a held-out set (4
    samples of another seed), 6 cameras at the nuScenes size 900 x 1600,
    under the git-ignored build/. `Trainer(ocrfdet_config(batch_size=2))`
    from `NuScenesDataset(is_train=True, cbgs=True)` and
    `Loader(num_workers=8)`: epoch 0 for `n_steps` steps (with_prev 0,
    no box mask), `save(0)`, a new trainer's `resume()` (it must return
    1 with the step count and every tensor of the state equal), epoch 2
    for `n_steps` steps (with_prev 1, box mask on). Each step must
    launch exactly `per_step`, every loss must be finite and no step may
    be skipped. Then `run_eval` of the resumed run's EMA weights over the
    held-out set at batch 1, each request an `entry.infer` call: exactly
    2 launches of each eval kernel, 1 of the NMS rows kernel and none of
    the others; the metrics dict and the results JSON's sample count."""
    import tempfile

    from ocrfdet_tpu_torch import entry, kernels
    from ocrfdet_tpu_torch.bench_train import percentile
    from ocrfdet_tpu_torch.config import ocrfdet_config
    from ocrfdet_tpu_torch.data.dataset import Loader, NuScenesDataset
    from ocrfdet_tpu_torch.data.fake_nuscenes import build_fake_nuscenes
    from ocrfdet_tpu_torch.ops import nms
    from ocrfdet_tpu_torch.train import evaluate
    from ocrfdet_tpu_torch.train.trainer import Trainer

    cfg = ocrfdet_config(batch_size=2)
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR,
                                     prefix="fake_nuscenes_") as root:
        t0 = time.perf_counter()
        train_pkl = build_fake_nuscenes(f"{root}/train", cfg, n_samples=8,
                                        img_hw=(900, 1600), seed=0,
                                        scene=True, scene_len=8)
        val_pkl = build_fake_nuscenes(f"{root}/val", cfg, n_samples=4,
                                      img_hw=(900, 1600), seed=1,
                                      scene=True, scene_len=4)
        log(f"[trainer] fake nuScenes (rendered scenes, "
            f"{cfg.data.num_cams} cameras at 900 x 1600, JPEG): 8 train "
            f"and 4 held-out samples in {time.perf_counter() - t0:.1f} s")
        dataset = NuScenesDataset(cfg, train_pkl, is_train=True, cbgs=True)
        loader = Loader(dataset, cfg.batch_size, num_workers=8)
        work_dir = f"{root}/work"

        def run(trainer, epoch):
            flags = trainer.epoch_flags(epoch)
            for k in all_kernels:
                k.launches = 0
            torch.cuda.reset_peak_memory_stats()
            st = trainer.run_epoch(loader, epoch, log_every=1,
                                   max_steps=n_steps)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 1e9
            launches = {k.name: k.launches for k in all_kernels}
            want = {k.name: per_step.get(k.name, 0) * n_steps
                    for k in all_kernels}
            if launches != want or st.steps != n_steps:
                raise AssertionError(f"epoch {epoch}: {st.steps} steps, "
                                     f"launches {launches}, expected {want}")
            bad = [k for m in st.metrics for k, v in m.items()
                   if not np.isfinite(v)]
            if bad or any(m["skipped_nonfinite"] for m in st.metrics):
                raise AssertionError(f"epoch {epoch}: non-finite {bad} or a "
                                     f"skipped step")
            log(f"[trainer] epoch {epoch} (with_prev {flags[0]:.0f}, box "
                f"mask {flags[1]:.0f}): {st.steps} steps of batch 2 from "
                f"disk in {st.wall_s:.3f} s, "
                f"{st.steps * cfg.batch_size / st.wall_s:.3f} frames/s; step "
                f"ms " + ", ".join(f"{t * 1e3:.3f}" for t in st.step_s)
                + "; loader wait ms per step "
                + ", ".join(f"{t * 1e3:.3f}" for t in st.wait_s)
                + f"; peak device memory {peak:.2f} GB; loss_total "
                + ", ".join(f"{m['loss_total']:.4f}" for m in st.metrics)
                + f"; launches exactly per_step x {n_steps}")
            return flags

        t0 = time.perf_counter()
        trainer = Trainer(cfg, work_dir, steps_per_epoch=len(loader),
                          device=dev)
        trainer.init_state()
        log(f"[trainer] Trainer built ({len(dataset)} CBGS samples, "
            f"{len(loader)} steps an epoch) in "
            f"{time.perf_counter() - t0:.1f} s")
        gates = [run(trainer, 0)]
        t0 = time.perf_counter()
        trainer.save(0)
        saved = trainer.state.state_dict()
        t_save = time.perf_counter() - t0
        del trainer
        resumed = Trainer(cfg, work_dir, steps_per_epoch=len(loader),
                          device=dev)
        resumed.init_state()
        t0 = time.perf_counter()
        start = resumed.resume()
        t_load = time.perf_counter() - t0
        diff = _state_equal(saved, resumed.state.state_dict())
        del saved
        if start != 1 or resumed.state.step != n_steps or diff:
            raise AssertionError(f"resume: epoch {start}, step "
                                 f"{resumed.state.step}, differs in "
                                 f"{diff[:8]}")
        size = os.path.getsize(f"{work_dir}/ckpt_epoch_0.pt") / 1e9
        log(f"[trainer] save(0) ({size:.2f} GB) in {t_save:.1f} s, resume() "
            f"in {t_load:.1f} s: returned 1, step {resumed.state.step}, every parameter, "
            f"buffer, moment, EMA tensor and the generator equal")
        gates.append(run(resumed, 2))
        if gates != [(0.0, 0.0), (1.0, 1.0)]:
            raise AssertionError(f"epoch gates {gates}")

        cfg1 = ocrfdet_config(batch_size=1)
        model = evaluate.ema_detector(cfg1, resumed.state, dev)
        del resumed
        torch.cuda.empty_cache()
        held_out = NuScenesDataset(cfg1, val_pkl, is_train=False, cbgs=False)
        eval_loader = Loader(held_out, 1, shuffle=False, drop_last=False,
                             num_workers=8)
        poses = {i["token"]: i["cams"]["CAM_FRONT"] for i in held_out.infos}
        per_request, times = [], []
        infer = entry.infer
        counted_kernels = all_kernels + [nms.ROWS_KERNEL]

        def counted(*args):
            before = [k.launches for k in counted_kernels]
            t = time.perf_counter()
            out = infer(*args)
            times.append(time.perf_counter() - t)
            per_request.append({k.name: k.launches - b
                                for k, b in zip(counted_kernels, before)})
            return out
        out_json = f"{root}/results.json"
        t0 = time.perf_counter()
        with mock.patch.object(entry, "infer", counted):
            metrics = evaluate.run_eval(cfg1, model, eval_loader,
                                        out_json=out_json,
                                        token_to_pose=poses)
        wall = time.perf_counter() - t0
        want = {k.name: 2 if k in eval_kernels else 0 for k in all_kernels}
        want[nms.ROWS_KERNEL.name] = 1
        if len(per_request) != len(held_out) or any(
                r != want for r in per_request):
            raise AssertionError(f"eval launches per request {per_request}, "
                                 f"expected {want} x {len(held_out)}")
        with open(out_json) as f:
            n_json = len(json.load(f)["results"])
        bad = [k for k in ("mAP", "NDS", "mATE") if k not in metrics or not (
            np.isnan(metrics[k]) or 0.0 <= metrics[k] <= 1.0)]
        if bad or n_json != len(held_out):
            raise AssertionError(f"eval: {bad} out of [0, 1] or missing, "
                                 f"{n_json} samples in the JSON")
        log(f"[trainer] EMA eval of the resumed run over {len(held_out)} "
            f"held-out samples at batch 1: {wall:.3f} s, request ms "
            f"(forward, decode, NMS) " + ", ".join(f"{t * 1e3:.3f}"
                                                    for t in times)
            + f" (median {percentile(times, 50) * 1e3:.3f}); exactly 2 "
            f"launches of each of K1-K4 and 1 of nms_rows per request; "
            f"{n_json} samples in "
            f"the results JSON; metrics " + json.dumps(
                {k: v for k, v in metrics.items() if k != "per_class_ap"}))


KERNEL_NAMES = ("K1", "K2", "K3", "K4", "K5")
JITTER_SEEDS = (100, 101, 102)


def _kernel_entries():
    """{name: (module, attribute of its wrapper, plain version)} of the
    kernels the training step calls (K2-K4 differentiate through their
    wrappers, K5's wrapper is its autograd Function)."""
    from ocrfdet_tpu_torch.ops import bev_pool as bp
    from ocrfdet_tpu_torch.ops import cost_volume as cvm
    from ocrfdet_tpu_torch.ops import ht_pool as htp
    from ocrfdet_tpu_torch.ops import point_sample as ps
    from ocrfdet_tpu_torch.ops.splat import composite as ct
    return {"K1": (cvm, "cost_volume", cvm.cost_volume_plain),
            "K2": (bp, "lss_pool", bp.lss_pool_plain),
            "K3": (htp, "ht_pool_points", htp.ht_pool_points_plain),
            "K4": (ps, "point_sample_points", ps.point_sample_points_plain),
            "K5": (ct, "composite_tiles", ct.composite_tiles_plain)}


@contextlib.contextmanager
def plain_versions(only=None):
    """Route the model's kernel wrappers (all, or those named in `only`)
    to their plain versions (for a reference run on the card): forwards,
    and the backwards through the plain forwards' autograd and K5's
    plain autograd Function. The view transformer runs eagerly: a
    captured graph replays the kernels it captured."""
    from ocrfdet_tpu_torch.models.detector import OcRFDet
    with contextlib.ExitStack() as stack:
        for name, (mod, attr, plain) in _kernel_entries().items():
            if only is None or name in only:
                stack.enter_context(mock.patch.object(mod, attr, plain))
        stack.enter_context(mock.patch.object(
            OcRFDet, "_vt_graphed", lambda self, imgs: False))
        yield


class _Jitter(torch.autograd.Function):
    """x (1 + eps n), n standard normal from `gen`; identity backward."""

    @staticmethod
    def forward(ctx, x, eps, gen):
        return x * (1.0 + eps * torch.randn(x.shape, generator=gen,
                                            device=x.device))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


@contextlib.contextmanager
def jittered(name, dev, seed=JITTER_SEEDS[0]):
    """Kernel `name`'s wrapper with a relative noise of one fp32 rounding
    (2^-23) times a standard normal (from `seed`) on its output."""
    mod, attr, _ = _kernel_entries()[name]
    f = getattr(mod, attr)
    eps = 2.0 ** -23
    gen = torch.Generator(device=dev).manual_seed(seed)

    def g(*args, **kwargs):
        return _Jitter.apply(f(*args, **kwargs), eps, gen)
    with mock.patch.object(mod, attr, g):
        yield


def check_slice(cfg, dev, tag, path_kernels, all_kernels, n_requests,
                n_batches=8, n_warmup=5):
    """Answer `n_requests` flagship requests (cycling over make_batch
    seeds 0..n_batches-1) through `entry.infer` after `n_warmup` warm-up
    requests, one at a time as a server would. Every kernel's count is
    set to 0 just before the window and read just after: each of
    `path_kernels` must have launched exactly once per temporal frame of
    each request, every other kernel never, and the NMS rows kernel
    (`ops/nms.py::ROWS_KERNEL`) once a request, every task's NMS scanning
    its rows; for the first requests, the rows of their decoded boxes
    must equal the host's pair tests' (`nms_rows` on the CPU) bit for
    bit, and their detections those of the scan of the host's rows. A
    GeoEnhDet model's teacher and aligner must not run. Returns each
    kernel's launches over the window, the rows kernel's under
    "nms_rows". Per request it takes
    the host-clock times `entry.infer` records (dispatch of the forward
    and decode, the wait for the decoded boxes, host NMS) and the whole
    request (until `entry.infer` returns); over the window, the main
    thread's CPU time (the thread CPU clock may tick only every few ms,
    too coarse for one request)."""
    from ocrfdet_tpu_torch import entry
    from ocrfdet_tpu_torch.bench_train import percentile
    from ocrfdet_tpu_torch.models.detector import OcRFDet
    from ocrfdet_tpu_torch.ops import nms

    t0 = time.perf_counter()
    model = entry.build_detector(cfg, dev, seed=0)
    log(f"[{tag}] built the {type(model).__name__} with_ocrf="
        f"{cfg.with_ocrf} detector, {cfg.num_frames} temporal frames, on "
        f"{dev} ({sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
        f"params, {time.perf_counter() - t0:.1f} s)")
    # the modules eval must not run: GeoEnhDet's teacher and aligner
    silent = {n: 0 for n in ("aggregator", "aligner") if hasattr(model, n)}
    for n in silent:
        getattr(model, n).register_forward_pre_hook(
            lambda *_, n=n: silent.__setitem__(n, silent[n] + 1))
    batches = [entry.make_batch(cfg, seed=s, device=dev)
               for s in range(n_batches)]
    for i in range(n_warmup):
        entry.infer(model, batches[i % n_batches])
    torch.cuda.synchronize()
    for k in all_kernels + [nms.ROWS_KERNEL]:
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
        want = cfg.num_frames * n_requests if k in path_kernels else 0
        if launches[k.name] != want:
            raise AssertionError(f"{k.name}: {launches[k.name]} launches "
                                 f"over {n_requests} requests, expected "
                                 f"{want}")
    rows_launches = launches["nms_rows"] = nms.ROWS_KERNEL.launches
    if rows_launches != n_requests:
        raise AssertionError(f"nms_rows: {rows_launches} launches over "
                             f"{n_requests} requests, expected one each")
    for p in parts:
        c = p["counts"]
        if c.get("nms_rows_tasks") != c["nms_tasks"]:
            raise AssertionError(f"{c.get('nms_rows_tasks')} of "
                                 f"{c['nms_tasks']} tasks scanned rows")
    for preds, aux, decoded, dets in outs:
        cpu = [d._replace(**{k: v.cpu() for k, v in d._asdict().items()})
               for d in decoded]
        host_rows = nms.nms_rows(cpu, cfg.head)
        bad = rows_differ(nms.nms_rows(decoded, cfg.head), host_rows)
        if bad:
            raise AssertionError(f"{bad} rows differ from the host's pair "
                                 f"tests")
        want = nms.multi_task_nms(
            [{k: v[0].numpy() for k, v in d._asdict().items()} for d in cpu],
            cfg.head, list(host_rows[:, 0].numpy().view(np.uint64)))
        if not all(np.array_equal(dets[0][k], want[k]) for k in want):
            raise AssertionError("the rows' detections differ from the "
                                 "host's pair tests")
    if any(silent.values()):
        raise AssertionError(f"eval ran the distillation modules: {silent}")
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
        f"{ms(wall, 100)} (request {int(np.argmax(wall))} of the window); "
        f"host dispatch ms median "
        f"{ms(col('dispatch'), 50)} p90 {ms(col('dispatch'), 90)}, "
        f"{sum(col('dispatch')) / sum(wall):.2%} of the requests' time; "
        f"wait for the device ms median {ms(col('wait'), 50)} (the decoded "
        f"boxes and the NMS rows); main thread "
        f"on CPU {cpu_window:.3f} s of the window "
        f"({cpu_window / window:.2%}); launches {launches}")
    log(f"[{tag}] decode + NMS rows on the card, greedy scan on the host: "
        f"NMS ms median {ms(col('nms'), 50)} p90 {ms(col('nms'), 90)}, "
        f"{rows_launches} nms_rows launches, every task's NMS a scan of "
        f"its rows, the first {len(outs)} requests' rows and detections "
        f"equal to the host's pair tests'; copy of the decoded boxes and "
        f"the rows (after the device is done) in the wait above; "
        f"{valid} decoded boxes above threshold -> "
        f"{len(outs[0][3][0]['boxes'])} detections (request 0)"
        + (f"; teacher and aligner calls {silent}" if silent else ""))
    # the same request in fp32, with the kernels and with the plain
    # versions, on the same weights (of the student alone: what eval runs)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    m32 = OcRFDet(cfg32)
    sd = model.state_dict()
    m32.load_state_dict({k: sd[k] for k in m32.state_dict()})
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
        want = cfg.num_frames if k in path_kernels else 0
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


def rows_differ(rows, host_rows) -> int:
    """The rows (of tasks and samples) where the NMS rows kernel's bits,
    rows [T, B, K, W] on the card, differ from `host_rows`, the host's
    pair tests (`ops/nms.py::nms_rows` of the decoded boxes on the CPU:
    glibc's sin and cos, not CUDA's)."""
    return int((rows.cpu() != host_rows).any(-1).sum())


def check_nms_rows(dev, smi):
    """The NMS rows kernel (`ops/nms.py::nms_rows`, `csrc/nms.cu`) at the
    served shapes: the flagship's decode (seeded random weights, the
    inputs of `make_batch`) at batch 1 and 4. Its rows must equal
    `nms_rows_plain`'s (on the CPU) and the host pair tests' (`nms_rows`
    on the CPU: glibc's sin and cos, not CUDA's) bit for bit, and the
    same bits on a second launch; the scan of its rows must give the set
    of the scan of the host's. Logs its device time (by three traces and
    by CUDA events), the plain version's host time, its bound and the
    host NMS of one sample with the card's rows (the scan) and with the
    host's (their pair tests, then the scan). The bound: the bytes at
    3.35 TB/s, the circle task's fp32 operations at 67 TFLOP/s, the
    rotated tasks' fp64 ones at 34 TFLOP/s, whichever takes longest; the
    operations are those the kernel's code does, counted by the plain
    version where it branches (`nms_rows_plain(work=)`: add, sub, mul,
    div and sqrt, each box's set-up once, sincos not counted). Those
    peaks count an FMA as two operations, and the kernel's arithmetic has
    none, so it cannot pass half the bound's pace. Returns {batch: stats}."""
    from ocrfdet_tpu_torch import entry
    from ocrfdet_tpu_torch.config import ocrfdet_config
    from ocrfdet_tpu_torch.ops import nms
    stats = {}
    for B in (1, 4):
        cfg = ocrfdet_config(batch_size=B)
        model = entry.build_detector(cfg, dev, seed=0)
        batch = entry.make_batch(cfg, seed=0, batch_size=B, device=dev)
        with torch.inference_mode():
            preds, _ = model(batch)
            decoded = entry.decode_all_tasks(preds, cfg.head, cfg.grid)
        del model, batch, preds
        torch.cuda.empty_cache()
        before = nms.ROWS_KERNEL.launches
        rows = nms.nms_rows(decoded, cfg.head)
        rows2 = nms.nms_rows(decoded, cfg.head)
        torch.cuda.synchronize()
        if nms.ROWS_KERNEL.launches != before + 2:
            raise AssertionError("nms_rows: not one launch a call")
        cpu = [d._replace(**{k: v.cpu() for k, v in d._asdict().items()})
               for d in decoded]
        t = time.perf_counter()
        want = nms.nms_rows_plain([d.boxes for d in cpu],
                                  [d.labels for d in cpu],
                                  *nms.task_params(cfg.head))
        plain_ms = (time.perf_counter() - t) * 1e3
        for got in (rows, rows2):
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"nms_rows at batch {B}: the kernel's "
                                     f"bits differ from the plain version's")
        host = [{k: v.numpy() for k, v in d._asdict().items()} for d in cpu]
        bad = rows_differ(rows, nms.nms_rows(cpu, cfg.head))
        if bad:
            raise AssertionError(f"nms_rows at batch {B}: {bad} rows differ "
                                 f"from the host's pair tests")
        traces = device_ms_traces(lambda: nms.nms_rows(decoded, cfg.head),
                                  reps=50)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(50):
            nms.nms_rows(decoded, cfg.head)
        end.record()
        torch.cuda.synchronize()
        T, K = len(decoded), decoded[0].boxes.shape[1]
        W = -(-K // 64)
        work = {}
        nms.nms_rows_plain([d.boxes for d in cpu], [d.labels for d in cpu],
                           *nms.task_params(cfg.head), work=work)
        nbytes_ = T * B * K * (9 * 4 + 8) + T * B * K * W * 8
        parts = dict(bytes=nbytes_ / 3.35e12, fp32=work["fp32"] / 67e12,
                     fp64=work["fp64"] / 34e12)
        bound_by = max(parts, key=parts.get)
        bound_ms = parts[bound_by] * 1e3
        bits = rows.cpu().numpy().view(np.uint64)
        tr = [{k: v[0] for k, v in d.items()} for d in host]
        task_rows = list(bits[:, 0])
        cpu0 = [d._replace(**{k: v[:1] for k, v in d._asdict().items()})
                for d in cpu]
        scan, pairs = [], []
        for _ in range(20):
            t = time.perf_counter()
            got = nms.multi_task_nms(tr, cfg.head, task_rows)
            scan.append(time.perf_counter() - t)
            t = time.perf_counter()
            host_rows = nms.nms_rows(cpu0, cfg.head)
            ref = nms.multi_task_nms(
                tr, cfg.head, list(host_rows[:, 0].numpy().view(np.uint64)))
            pairs.append(time.perf_counter() - t)
        if not all(np.array_equal(got[k], ref[k]) for k in ref):
            raise AssertionError("the scan's set differs from the pair "
                                 "tests'")
        st = dict(ms=float(np.median(traces)), ms_traces=traces,
                  ms_events=start.elapsed_time(end) / 50,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                  bytes=nbytes_, fp32_ops=work["fp32"],
                  fp64_ops=work["fp64"], near_pairs=work["near_pairs"],
                  pairs=T * B * K * K,
                  bits=int(np.unpackbits(bits.view(np.uint8)).sum()),
                  host_scan_ms=float(np.median(scan)) * 1e3,
                  host_pair_tests_ms=float(np.median(pairs)) * 1e3)
        log(f"[nms-rows] batch {B}: rows [{T}, {B}, {K}, {W}] equal to the "
            f"plain version's (twice) and the host pair tests' bit for "
            f"bit, {st['bits']} bits set; kernel "
            f"{st['ms']:.4f} ms a call (traces "
            f"{', '.join(f'{x:.4f}' for x in traces)}; CUDA events "
            f"{st['ms_events']:.4f}), bound {bound_ms:.4f} ms by "
            f"{bound_by} ({nbytes_} B, {work['fp32']} fp32 and "
            f"{work['fp64']} fp64 operations; {work['near_pairs']} of "
            f"{T * B * K * K} pairs clipped), plain version on the CPU "
            f"{plain_ms:.1f} ms; host NMS of sample 0: the scan "
            f"{st['host_scan_ms']:.3f} ms, the host's rows and their scan "
            f"{st['host_pair_tests_ms']:.3f} ms; nvidia-smi: {smi}")
        stats[B] = st
        del decoded, rows, rows2
        torch.cuda.empty_cache()
    return stats


def variant_launches(per_step):
    """The launches per training step of each variant the [tools] phase
    runs, from the code: "full" is the flagship step (`per_step`); the
    "sample" seam drops K4 (forward, backward and its binning), "splat"
    and "render" drop K5 (the NeRF alphas still go through K4 for HOA),
    use_stereo=False drops K1, with_ocrf=False drops K3, K4 and K5."""
    k3 = {"ht_pool", "ht_pool_bwd", "ht_pool_order"}
    k4 = {"point_sample", "point_sample_bwd", "point_sample_order"}
    k5 = {"composite_tiles", "composite_tiles_bwd"}
    drops = {"full": set(), "ablate_sample": k4, "ablate_splat": k5,
             "ablate_render": k5, "no_stereo": {"cost_volume"},
             "no_ocrf": k3 | k4 | k5}
    return {name: {k: n for k, n in per_step.items() if k not in d}
            for name, d in drops.items()}


def _quiet(fn, *args):
    """fn(*args) with its standard output kept out of this script's."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def check_tools(dev, per_step):
    """The measuring tools on the card: `step_variants` in this process
    (the variants of `variant_launches`, interleaved, 2 warm-up and 3
    timed steps each, one traced step each for the busy time; each
    variant's launches per step must equal the table), `benchmark_infer`
    (flagship, 3 warm-up + 20), `get_flops` (flagship, eval and train)
    and `profile_step --fwd-only` (its categories must add up to its
    traced busy time within 1%)."""
    from ocrfdet_tpu_torch.tools import (benchmark_infer, get_flops,
                                         profile_step, step_variants)

    table = variant_launches(per_step)
    t0 = time.perf_counter()
    variants = step_variants.run(list(table), steps=3, warmup=2,
                                 batch_size=2, device=dev)
    for name, r in variants.items():
        got = {k: n for k, n in r["launches_per_step"].items() if n}
        if got != table[name] or r["skipped"] or not np.isfinite(
                r["loss_total"]):
            raise AssertionError(f"step_variants {name}: launches per step "
                                 f"{got}, expected {table[name]}; skipped "
                                 f"{r['skipped']}, loss {r['loss_total']}")
        delta = ("" if name == "full" else
                 f", delta vs full {r['delta_ms_vs_full']:.3f} ms step, "
                 f"{r['delta_busy_ms_vs_full']:.3f} ms busy")
        log(f"[tools] step_variants {name}: step ms median "
            f"{r['step_ms_median']:.3f} (steps "
            f"{', '.join(f'{t:.1f}' for t in r['step_ms'])}), busy "
            f"{r['busy_ms_per_step']:.3f} ms a step{delta}; launches a step "
            f"{got} (as the table)")
    log(f"[tools] step_variants: {len(variants)} variants x 5 steps + 1 "
        f"traced in {time.perf_counter() - t0:.1f} s")
    del variants
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bi = _quiet(benchmark_infer.main, ["--warmup", "3", "--iters", "20"])
    log(f"[tools] benchmark_infer flagship batch 1 ({bi['device']}): "
        f"{bi['frames_per_s']:.3f} frames/s, {bi['ms_per_batch']:.3f} ms a "
        f"batch (forward + decode, no NMS); {time.perf_counter() - t0:.1f} s")
    for mode in ([], ["--train"]):
        t0 = time.perf_counter()
        gf = _quiet(get_flops.main, mode)
        rows = "; ".join(f"{k} x{r['calls']} {r['flops'] / 1e9:.3f} GFLOP "
                         f"{r['bytes'] / 1e6:.1f} MB"
                         for k, r in gf["kernels"].items() if r["calls"])
        log(f"[tools] get_flops flagship {'train' if mode else 'eval'} "
            f"batch 1: {gf['params'] / 1e6:.3f} M params; forward "
            f"{gf['torch_flops'] / 1e9:.2f} GFLOP by FlopCounterMode + "
            f"{gf['kernel_flops'] / 1e9:.3f} GFLOP in the kernels (by "
            f"ops/work.py: {rows}) = {gf['total_flops'] / 1e9:.2f} GFLOP; "
            f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ps = _quiet(profile_step.main, ["--fwd-only", "--steps", "3"])
    total = sum(ps["category_ms"].values())
    busy = ps["device_busy_ms"]
    ok = abs(total - busy) <= 0.01 * busy
    log(f"[tools] profile_step --fwd-only (batch {ps['batch_size']}): busy "
        f"{busy:.3f} ms a forward, idle {ps['device_idle_share']:.1%}; by "
        f"category " + ", ".join(f"{k} {v:.3f}" for k, v in
                                 ps["category_ms"].items())
        + f" = {total:.3f} ms ({'within' if ok else 'NOT within'} 1% of the "
        f"busy time); top kernel {ps['top_kernels_ms'][0][0]} "
        f"{ps['top_kernels_ms'][0][1]:.3f} ms; "
        f"{time.perf_counter() - t0:.1f} s")
    if not ok:
        raise AssertionError(f"profile_step: categories {total} ms, busy "
                             f"{busy} ms")


def _flat(tree) -> list:
    return torch.utils._pytree.tree_flatten(tree)[0]


def _max_err(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max()) if a.numel()
               else 0.0 for a, b in zip(_flat(got), _flat(want)))


def check_export(dev, all_kernels, eval_kernels, smi, n_requests=20):
    """`tools/export.py` on the card: the flagship `ocrfdet_config(
    batch_size=1)` inference program (forward + decode, no NMS) exported
    in fp32 and in the configured bf16 towers, saved under build/ and
    loaded back (`load_program`). On the OcRF slice's requests
    (make_batch seeds 0-3) the loaded fp32 program must give eager's
    forward and decode bit for bit, and the bf16 one must agree with
    eager bf16 within `check_slice`'s bound (heatmap 1e-3 of its scale,
    depth 1e-5); the loaded program must launch each of K1-K4 twice a
    request and nothing else. Then `n_requests` requests through the
    loaded bf16 program and as many eager forward + decode calls,
    interleaved A B A B, each synchronised: the medians."""
    from ocrfdet_tpu_torch import entry, kernels
    from ocrfdet_tpu_torch.bench_train import percentile
    from ocrfdet_tpu_torch.config import ocrfdet_config
    from ocrfdet_tpu_torch.tools import export

    cfg = ocrfdet_config(batch_size=1)
    batches = [entry.make_batch(cfg, seed=s, device=dev) for s in range(4)]
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    programs = {}
    for dtype in ("float32", cfg.compute_dtype):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        model = entry.build_detector(c, dev, seed=0)
        eager = export.InferProgram(model)
        path = kernels.BUILD_DIR / f"ocrfdet_infer_{dtype}.pt2"
        t0 = time.perf_counter()
        ep = export.export_program(model, batches[0])
        t_export = time.perf_counter() - t0
        nodes = export.custom_op_nodes(ep)
        t0 = time.perf_counter()
        torch.export.save(ep, str(path))
        t_save = time.perf_counter() - t0
        del ep
        t0 = time.perf_counter()
        program = export.load_program(str(path))
        t_load = time.perf_counter() - t0
        want_nodes = {k: cfg.num_frames for k in
                      ("cost_volume", "bev_pool", "ht_pool", "point_sample")}
        if nodes != want_nodes:
            raise AssertionError(f"[export] {dtype}: custom op nodes {nodes}"
                                 f", expected {want_nodes}")
        errs, same = [], []
        for b in batches:
            with torch.inference_mode():
                want = eager(b)
                again = eager(b)
                for k in all_kernels:
                    k.launches = 0
                got = program(b)
                torch.cuda.synchronize()
            launches = {k.name: k.launches for k in all_kernels}
            expect = {k.name: cfg.num_frames if k in eval_kernels else 0
                      for k in all_kernels}
            if launches != expect:
                raise AssertionError(f"[export] {dtype}: the loaded program "
                                     f"launched {launches}, expected "
                                     f"{expect}")
            errs.append(_max_err(got, want))
            same.append(all(torch.equal(a, b_) for a, b_ in
                            zip(_flat(got), _flat(want))))
            eager_same = all(torch.equal(a, b_) for a, b_ in
                             zip(_flat(again), _flat(want)))
            if dtype == "float32" and not same[-1]:
                raise AssertionError(
                    f"[export] fp32 program vs eager: max abs err "
                    f"{errs[-1]:.3e} (eager vs eager bitwise: {eager_same})")
            preds_g, aux_g, _ = got
            preds_w, aux_w, _ = want
            heat = float((preds_g[0]["heatmap"].float()
                          - preds_w[0]["heatmap"].float()).abs().max())
            scale = float(preds_w[0]["heatmap"].float().abs().max())
            depth = float((aux_g["depth"].float()
                           - aux_w["depth"].float()).abs().max())
            if heat > 1e-3 * max(1.0, scale) or depth > 1e-5:
                raise AssertionError(f"[export] {dtype}: heatmap {heat:.3e}"
                                     f" (scale {scale:.3f}), depth "
                                     f"{depth:.3e} past the slice's bound")
        log(f"[export] {dtype} flagship program: export {t_export:.1f} s, "
            f"save {t_save:.1f} s ({path.stat().st_size / 1e6:.1f} MB), load "
            f"{t_load:.1f} s; custom op nodes {nodes}; on {len(batches)} "
            f"requests vs eager: bitwise {same}, max abs err "
            f"{max(errs):.3e}; 2 launches of each of K1-K4 a request; "
            f"nvidia-smi: {smi}")
        programs[dtype] = (program, eager)
    program, eager = programs[cfg.compute_dtype]
    times = {"program": [], "eager": []}
    for i in range(n_requests + 2):
        b = batches[i % len(batches)]
        for name, fn in (("program", program), ("eager", eager)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.inference_mode():
                fn(b)
            torch.cuda.synchronize()
            if i >= 2:                       # two warm-up rounds
                times[name].append(time.perf_counter() - t)
    med = {k: percentile(v, 50) * 1e3 for k, v in times.items()}
    log(f"[export] {n_requests} {cfg.compute_dtype} requests (forward + "
        f"decode, synchronised) through the loaded program and eager, "
        f"interleaved: median ms program {med['program']:.3f}, eager "
        f"{med['eager']:.3f} (p90 {percentile(times['program'], 90) * 1e3:.3f}"
        f" / {percentile(times['eager'], 90) * 1e3:.3f}); nvidia-smi: {smi}")
    del programs, program, eager
    gc.collect()
    torch.cuda.empty_cache()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _grid_sample_gathered(img, grid, align_corners):
    """F.grid_sample's bilinear, zero padding, as four gathers: its
    backward is a deterministic scatter-add."""
    B, C, H, W = img.shape
    h, w = grid.shape[1:3]
    gx, gy = grid[..., 0].float(), grid[..., 1].float()
    if align_corners:
        ix, iy = (gx + 1) / 2 * (W - 1), (gy + 1) / 2 * (H - 1)
    else:
        ix, iy = ((gx + 1) * W - 1) / 2, ((gy + 1) * H - 1) / 2
    x0, y0 = ix.floor(), iy.floor()
    fx, fy = ix - x0, iy - y0
    flat = img.reshape(B, C, H * W)
    out = 0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xx, yy = x0 + dx, y0 + dy
            inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
            v = torch.gather(flat, 2, idx.reshape(B, 1, h * w)
                             .expand(B, C, h * w)).reshape(B, C, h, w)
            out = out + v * (wx * wy * inside)[:, None]
    return out


@contextlib.contextmanager
def deterministic_step():
    """`torch.use_deterministic_algorithms(True)`: every op of the
    training step that has a deterministic form runs it, and one that has
    none raises. Of the flagship step's ops only F.grid_sample's backward
    (the deformable attention) has none (torch 2.11 on the H100); its
    bilinear form is replaced by four gathers, whose backward is a
    deterministic scatter-add. The kernels are untouched."""
    import torch.nn.functional as F
    grid_sample = F.grid_sample

    def det_grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=None):
        if mode != "bilinear" or padding_mode != "zeros":
            return grid_sample(img, grid, mode=mode,
                               padding_mode=padding_mode,
                               align_corners=align_corners)
        return _grid_sample_gathered(img, grid, bool(align_corners))

    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    F.grid_sample = det_grid_sample
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        F.grid_sample = grid_sample
        if cublas is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas


def check_ddp(dev, all_kernels, per_step, smi, n_steps=3):
    """The data axis (`parallel/`) at world size 1 over NCCL: a process
    group of this one process; the flagship at batch 2 from the same seed
    as a data rank (D: `parallel/step.py::DataParallelState`, whose
    collectives are NCCL all-reduces and, past one rank, the ZeRO
    all-gather) and on one device (S: `TrainState`, no collectives), each
    through the one `train_step`, step by step, `n_steps` steps, under
    `deterministic_step()`, so that two runs of the step give the same
    bits. Every step D launches `per_step`, and D, updating from its own
    averaged gradients, must give S's losses, S's gradients as the
    optimizer receives them, and after the update every parameter and
    buffer of S, bit for bit; after the last step D's gathered state
    (`DataParallelState.state_dict`) must equal S's whole state. Then
    `run_eval` of D's EMA weights over a fake nuScenes of 2 samples with
    the process group and without it must give the same metrics. The
    process group is released at the end."""
    import tempfile

    from ocrfdet_tpu_torch import entry, kernels
    from ocrfdet_tpu_torch.bench_train import percentile
    from ocrfdet_tpu_torch.config import ocrfdet_config
    from ocrfdet_tpu_torch.data.dataset import Loader, NuScenesDataset
    from ocrfdet_tpu_torch.data.fake_nuscenes import build_fake_nuscenes
    from ocrfdet_tpu_torch.parallel import mesh as pmesh
    from ocrfdet_tpu_torch.parallel import step as pstep
    from ocrfdet_tpu_torch.train import evaluate

    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                      MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    cfg = ocrfdet_config(batch_size=2)
    t0 = time.perf_counter()
    mesh = pmesh.init_data_mesh(cfg.batch_size)
    try:
        S = entry.build_trainer(cfg, dev, seed=0)
        D = pstep.build_trainer(cfg, mesh, seed=0)
        batches = [entry.make_batch(cfg, seed=s, batch_size=2, device=dev,
                                    with_targets=True) for s in range(2)]
        log(f"[ddp] NCCL process group of world size {mesh.world} (data "
            f"{mesh.data}) on {mesh.device}; 2 flagship trainers in "
            f"{time.perf_counter() - t0:.1f} s")

        def recording(state):
            """Record the gradients `state`'s optimizer is given."""
            got = {}
            update = state.optimizer.update

            def record(grads, count):
                got["grads"] = [g.detach().clone() for g in grads]
                return update(grads, count)
            state.optimizer.update = record
            return got
        s_rec, d_rec = recording(S), recording(D)
        names = S.optimizer.names["render"] + S.optimizer.names["other"]
        # the stand-in computes F.grid_sample's function
        g = torch.Generator(device=dev).manual_seed(5)
        img = torch.rand(2, 64, 16, 44, generator=g, device=dev)
        grid = torch.rand(2, 16, 44, 2, generator=g, device=dev) * 2.4 - 1.2
        err = float((_grid_sample_gathered(img, grid, False)
                     - torch.nn.functional.grid_sample(
                         img, grid, align_corners=False)).abs().max())
        if err > 1e-5:
            raise AssertionError(f"[ddp] the gathered grid sample is "
                                 f"{err:.3e} from F.grid_sample")
        times = {"S": [], "D": []}
        with deterministic_step():
            for i in range(n_steps):
                b = batches[i % 2]
                torch.cuda.synchronize()
                t = time.perf_counter()
                m_s = entry.train_step(S, b)
                torch.cuda.synchronize()
                times["S"].append(time.perf_counter() - t)
                for k in all_kernels:
                    k.launches = 0
                torch.cuda.synchronize()
                t = time.perf_counter()
                m_d = entry.train_step(D, b)
                torch.cuda.synchronize()
                times["D"].append(time.perf_counter() - t)
                got = {k.name: k.launches for k in all_kernels}
                want = {k.name: per_step.get(k.name, 0) for k in all_kernels}
                if got != want:
                    raise AssertionError(f"[ddp] step {i}: launches {got}, "
                                         f"expected {want}")
                if m_d != m_s:
                    raise AssertionError(
                        f"[ddp] step {i}: losses differ: " + ", ".join(
                            f"{k} {m_d[k]!r} vs {m_s[k]!r}" for k in m_s
                            if m_d.get(k) != m_s[k]))
                diff = [n for n, x, y in zip(names, d_rec["grads"],
                                             s_rec["grads"])
                        if not torch.equal(x, y)]
                if diff:
                    raise AssertionError(
                        f"[ddp] step {i}: the gradients of {len(diff)} of "
                        f"{len(names)} tensors differ: {diff[:6]}")
                sd_s, sd_d = S.model.state_dict(), D.model.state_dict()
                diff = [k for k in sd_s if not torch.equal(sd_s[k], sd_d[k])]
                if diff:
                    raise AssertionError(f"[ddp] step {i}: {len(diff)} "
                                         f"tensors differ after the update: "
                                         f"{diff[:4]}")
        diff = _state_equal(S.state_dict(), D.state_dict())
        if diff:
            raise AssertionError(f"[ddp] the gathered state differs in "
                                 f"{len(diff)} keys: {diff[:8]}")
        med = {k: percentile(v[1:], 50) * 1e3 for k, v in times.items()}
        log(f"[ddp] {n_steps} flagship steps at batch 2 under "
            f"deterministic_step (its grid sample {err:.1e} from "
            f"F.grid_sample's), D from its own averaged gradients: losses "
            f"(loss_total {m_s['loss_total']!r} at the last), the gradients "
            f"of all {len(names)} tensors, every parameter and buffer after "
            f"each update bit for bit, and the gathered ZeRO state (moments,"
            f" EMAs, generator) equal to S's; launches per_step a step; "
            f"step ms median after the first D {med['D']:.3f} (steps "
            + ", ".join(f"{t * 1e3:.1f}" for t in times["D"])
            + f"), S {med['S']:.3f} (steps "
            + ", ".join(f"{t * 1e3:.1f}" for t in times["S"])
            + f"); nvidia-smi: {smi}")
        del S, batches
        gc.collect()
        torch.cuda.empty_cache()

        cfg1 = ocrfdet_config(batch_size=1)
        model = evaluate.ema_detector(cfg1, D, dev)
        del D
        with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR,
                                         prefix="ddp_eval_") as root:
            pkl = build_fake_nuscenes(f"{root}/val", cfg1, n_samples=2,
                                      img_hw=(900, 1600), seed=2)
            held_out = NuScenesDataset(cfg1, pkl, is_train=False, cbgs=False)
            results = {}
            for name, m in (("group", mesh), ("alone", None)):
                loader = Loader(held_out, 1, shuffle=False, drop_last=False,
                                num_workers=2)
                results[name] = evaluate.run_eval(cfg1, model, loader,
                                                  mesh=m)
        as_text = {k: json.dumps(v, sort_keys=True, default=float)
                   for k, v in results.items()}
        if as_text["group"] != as_text["alone"]:
            raise AssertionError(f"[ddp] run_eval with the process group "
                                 f"{results['group']} != without "
                                 f"{results['alone']}")
        log(f"[ddp] run_eval of D's EMA over 2 fake nuScenes samples with "
            f"the process group = without it: " + json.dumps(
                {k: v for k, v in results["group"].items()
                 if k != "per_class_ap"}))
    finally:
        pmesh.release()
        gc.collect()
        torch.cuda.empty_cache()
    log("[ddp] process group released")


# ------------------------------------------------------------ [space]
SPACE = 2               # the [space] phase's ranks, all on the one card
SPACE_STEPS = 3
SPACE_REQUESTS = 20
# per training step and rank, at space 2 as at space 1: K1 and each
# forward of K2-K4 once per temporal frame on the rank's 3 cameras, the
# backwards once, K5 once on the rank's band of rows
PER_STEP = {"cost_volume": 2, "bev_pool": 2, "ht_pool": 2,
            "point_sample": 2, "bev_pool_bwd": 1, "ht_pool_bwd": 1,
            "ht_pool_order": 1, "point_sample_bwd": 1,
            "point_sample_order": 1, "composite_tiles": 1,
            "composite_tiles_bwd": 1}
# the kernels of each model-level wrapper (forward, backward)
WRAPPER_KERNELS = {"K1": ("cost_volume", None),
                   "K2": ("bev_pool", "bev_pool_bwd"),
                   "K3": ("ht_pool", "ht_pool_bwd"),
                   "K4": ("point_sample", "point_sample_bwd"),
                   "K5": ("composite_tiles", "composite_tiles_bwd")}
# tolerances of the kernels against their plain versions on the ranks'
# recorded inputs, those of phases 3 and 7: (forward rtol, forward atol,
# atol a multiple of the output's scale?), backward (rtol, atol x scale)
REPLAY_TOL = {"K1": ((1e-5, 1e-3, False), None),
              "K2": ((1e-5, 1e-5, False), (1e-5, 1e-5)),
              "K3": ((1e-5, 1e-5, True), (1e-5, 1e-5)),
              "K4": ((0.0, 0.0, False), (1e-5, 1e-5)),
              "K5": ((1e-4, 1e-5, True), (1e-4, 1e-5))}


def _kernel_lists():
    """(the nine kernel functions and K4's backward binning, those and
    K3's backward ordering: the kernels whose launches are counted)."""
    from ocrfdet_tpu_torch.ops import bev_pool as bp
    from ocrfdet_tpu_torch.ops import cost_volume as cvm
    from ocrfdet_tpu_torch.ops import ht_pool as htp
    from ocrfdet_tpu_torch.ops import point_sample as ps
    from ocrfdet_tpu_torch.ops.splat import composite as ct
    kernel_list = [cvm.KERNEL, bp.KERNEL, bp.BWD_KERNEL, htp.KERNEL,
                   htp.BWD_KERNEL, ps.KERNEL, ps.BWD_KERNEL, ct.KERNEL,
                   ct.BWD_KERNEL, ps.ORDER_KERNEL]
    return kernel_list, kernel_list + [htp.ORDER_KERNEL]


def _space_configs(space=1):
    """The [space] phase's flagship configs at `space` (camera sharding
    on, `shard_vt`, `shard_bev` and `shard_render` at their defaults):
    the fp32 eval request, the configured bf16 eval window (batch 1)
    and the training step (batch 2) in fp32 with the ASPP dropout off
    (each rank draws its own masks, so a sharded and a single-device
    step would drop different features)."""
    from ocrfdet_tpu_torch.config import ocrfdet_config

    def at(cfg):
        return dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, space_axis=space, shard_cameras=True))
    e = ocrfdet_config(batch_size=1)
    t = ocrfdet_config(batch_size=2, compute_dtype="float32")
    t = dataclasses.replace(t, vt=dataclasses.replace(
        t.vt, depthnet=dataclasses.replace(t.vt.depthnet,
                                           aspp_dropout=0.0)))
    return (at(dataclasses.replace(e, compute_dtype="float32")), at(e),
            at(t))


def _camera0_batches(cfg, dev):
    """Two training batches (seeds 0, 1) with camera 0 copied over every
    camera of every per-camera tensor and render camera 0 (the input of
    JAX's tests/test_parallel.py gradient test): each rank's image
    backbone normalises its block of cameras alone, as JAX's does, and
    on identical cameras its statistics are the whole batch's."""
    from ocrfdet_tpu_torch import entry
    N = cfg.data.num_cams
    out = []
    for seed in range(2):
        b = entry.make_batch(cfg, seed=seed, batch_size=2, device=dev,
                             with_targets=True)
        for k, v in b.items():
            if not torch.is_tensor(v) or k in ("gt_boxes", "kd_pair"):
                continue
            if v.dim() >= 3 and v.shape[2] == N:
                b[k] = v[:, :, :1].expand_as(v).contiguous()
            elif v.dim() >= 2 and v.shape[1] == N:
                b[k] = v[:, :1].expand_as(v).contiguous()
        b["render_cam"] = torch.zeros_like(b["render_cam"])
        out.append(b)
    return out


def _recording_grads(state):
    """Record the gradients `state`'s optimizer is given (averaged over
    the grid, before the clip)."""
    got = {}
    update = state.optimizer.update

    def record(grads, count):
        got["grads"] = [g.detach().clone() for g in grads]
        return update(grads, count)
    state.optimizer.update = record
    return got


def probe_grads(model, batch):
    """The gradients of a fixed random linear functional of the eval
    forward's outputs (every head and the aux maps; normal weights from
    seed 31 on the model's device) with respect to the model's
    parameters: the backward of every kernel and collective of the eval
    path, where eval-mode BatchNorm keeps the function smooth. Returns
    (names, gradients; zeros where a parameter gets none)."""
    params = dict(model.named_parameters())
    preds, aux = model(batch)
    gen = torch.Generator(device=aux["depth"].device).manual_seed(31)
    terms = [v for t in preds for v in t.values()] + [
        aux[k] for k in ("depth", "semantic", "bev_mask_logit",
                         "opacity_bev_logit")]
    loss = sum((t.float() * torch.randn(t.shape, generator=gen,
                                        device=t.device)).sum()
               for t in terms)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return list(params), [torch.zeros_like(p) if g is None else g
                          for p, g in zip(params.values(), grads)]


def _tol_ratio(got, want, rtol, atol):
    """(max |got - want|, max |want|, the elements beyond atol + rtol
    |want|, the largest |got - want| / (atol + rtol |want|))."""
    got, want = got.detach(), want.detach()
    diff = (got - want).abs()
    ratio = diff / (atol + rtol * want.abs())
    return (float(diff.max()), float(want.abs().max()),
            int((ratio > 1).sum()), float(ratio.max()))


def replay_kernels(recorded, dev):
    """Each recorded kernel input through the wrapper (its kernels) and
    through its plain version: the forward, and the backward of random
    cotangents with respect to the inputs that required grad, within
    REPLAY_TOL (K5: its image and log-transmittance; the median depth may
    flip where T crosses 0.5 within rounding, at most 1 pixel in 10^4).
    Returns {kernel name: max |kernel - plain|}; raises beyond the
    tolerance, naming every output and gradient that is beyond it."""
    gen = torch.Generator(device=dev).manual_seed(21)
    errs, bad = {}, []
    for key, (mod, attr, plain) in _kernel_entries().items():
        args, req = recorded[key]
        runs = []
        for fn in (getattr(mod, attr), plain):
            a = [t.detach().clone().requires_grad_(r) if torch.is_tensor(t)
                 else t for t, r in zip(args, req)]
            out = fn(*a)
            runs.append((a, list(out) if isinstance(out, tuple) else [out]))
        (ka, kout), (pa, pout) = runs
        (rtol, atol, rel), bwd_tol = REPLAY_TOL[key]
        fwd_name, bwd_name = WRAPPER_KERNELS[key]
        shapes = [tuple(t.shape) for t in args if torch.is_tensor(t)]
        checks = []
        for i in ([0, 2] if key == "K5" else range(len(kout))):
            scale = float(pout[i].detach().abs().max()) if rel else 1.0
            checks.append((fwd_name, f"output {i}", _tol_ratio(
                kout[i], pout[i], rtol, atol * scale)))
        if key == "K5":
            flips = int((kout[1] - pout[1]).detach().abs().gt(
                1e-5 * pout[1].detach().abs()).sum())
            if flips > kout[1].numel() // 10000:
                bad.append(f"{fwd_name} median depth: {flips} flips")
        if bwd_name is not None:
            outs = [i for i, o in enumerate(kout) if o.requires_grad]
            cots = [torch.randn(kout[i].shape, generator=gen, device=dev)
                    for i in outs]
            wrt = [i for i, r in enumerate(req) if r]
            dk = torch.autograd.grad([kout[i] for i in outs],
                                     [ka[i] for i in wrt], cots)
            dp = torch.autograd.grad([pout[i] for i in outs],
                                     [pa[i] for i in wrt], cots)
            for i, x, y in zip(wrt, dk, dp):
                scale = float(y.abs().max())
                checks.append((bwd_name, f"d argument {i}", _tol_ratio(
                    x, y, bwd_tol[0], bwd_tol[1] * scale)))
        for name, what, (err, scale, n_bad, ratio) in checks:
            errs[name] = max(errs.get(name, 0.0), err)
            if n_bad:
                bad.append(f"{name} {what} on {shapes}: max |diff| {err:.3e}"
                           f" of {scale:.3e}, {n_bad} elements beyond the "
                           f"tolerance, at most {ratio:.2f} x it")
    if bad:
        raise AssertionError("[space] kernels vs plain: " + "; ".join(bad))
    errs["point_sample_order"] = errs["point_sample_bwd"]
    return errs


def _update_gap(model, want, cfg, step):
    """The largest |p - want| over the parameters, less two roundings of
    |want|, in learning rates of the update at `step` (the render MLPs'
    times their multiplier): AdamW moves an entry by about one learning
    rate, in either direction where the two gradients' signs differ."""
    from ocrfdet_tpu_torch.train import optim
    lr = optim.lr_at(cfg, step)
    worst = 0.0
    with torch.no_grad():
        for n, p in model.named_parameters():
            w = want[n].to(p.device)
            k_lr = lr * (cfg.lr_mult_render if optim.is_render_param(n)
                         else 1.0)
            gap = ((p - w).abs() - 2 * torch.finfo(torch.float32).eps
                   * w.abs()) / k_lr
            worst = max(worst, float(gap.max()))
    return worst


def _reset(kernel_list):
    for k in kernel_list:
        k.launches = 0


def _launches(kernel_list, want, where):
    got = {k.name: k.launches for k in kernel_list}
    want = {k.name: want.get(k.name, 0) for k in kernel_list}
    if got != want:
        raise AssertionError(f"[space] {where}: launches {got}, expected "
                             f"{want}")
    return got


def space_rank(work_dir: str) -> int:
    """One rank of the [space] phase, `python3 chip_smoke.py --space-rank
    DIR` under torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), which `check_space`
    sets: the process grid data 1 x space 2 on the one card (gloo, as
    `init_data_mesh` picks where ranks share a card); the fp32 eval
    request (rank 0 writes its outputs), the bf16 eval window, then
    SPACE_STEPS training steps under `deterministic_step` on the
    camera-0 batches, each from the single device's state before it
    (DIR/model<i>.pt; rank 0 writes the averaged gradients of each, and
    each rank measures its parameters after the update against the
    single device's), every kernel's launches counted for each request
    and step, and each
    kernel against its plain version on the inputs it was given in the
    first step. Writes DIR/rank<r>.json."""
    import torch.distributed as dist

    from ocrfdet_tpu_torch import entry
    from ocrfdet_tpu_torch.bench_train import percentile
    from ocrfdet_tpu_torch.parallel import collectives as col
    from ocrfdet_tpu_torch.parallel import mesh as pmesh
    from ocrfdet_tpu_torch.parallel import step as pstep

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work_dir = Path(work_dir)
    _, kernel_list = _kernel_lists()
    eval_want = {"cost_volume": 2, "bev_pool": 2, "ht_pool": 2,
                 "point_sample": 2}
    t0 = time.perf_counter()
    mesh = pmesh.init_data_mesh(1, space=SPACE)
    dev = mesh.device
    if (mesh.backend, mesh.data, mesh.space) != ("gloo", 1, SPACE):
        raise AssertionError(f"[space] mesh {mesh}")
    rep = dict(rank=mesh.rank, s=mesh.s, backend=mesh.backend,
               device=str(dev), init_s=time.perf_counter() - t0)
    cfg32, cfg_bf, cfg_t = _space_configs(SPACE)
    try:
        # the fp32 request
        model = entry.build_detector(cfg32, dev, seed=0)
        model.set_space(mesh.space_axis)
        batch = entry.make_batch(cfg32, seed=0, device=dev)
        _reset(kernel_list)
        preds, aux, _, _ = entry.infer(model, batch)
        rep["eval_launches"] = _launches(kernel_list, eval_want,
                                         "the fp32 request")
        # the probe's gradients, averaged over the grid as the step
        # averages them
        _, grads = probe_grads(model, batch)
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.grid)
        flat /= mesh.data * mesh.space
        if mesh.rank == 0:
            torch.save(dict(preds=[{k: v.cpu() for k, v in t.items()}
                                   for t in preds],
                            aux={k: v.cpu() for k, v in aux.items()},
                            probe=[p.cpu() for p in flat.split(
                                [g.numel() for g in grads])]),
                       work_dir / "eval.pt")
        del grads, flat
        # the bf16 window
        del model, preds, aux
        model = entry.build_detector(cfg_bf, dev, seed=0)
        model.set_space(mesh.space_axis)
        batches = [entry.make_batch(cfg_bf, seed=s, device=dev)
                   for s in range(4)]
        for i in range(3):
            entry.infer(model, batches[i % 4])
        _reset(kernel_list)
        wall = []
        for i in range(SPACE_REQUESTS):
            t = time.perf_counter()
            entry.infer(model, batches[i % 4])
            wall.append(time.perf_counter() - t)
        _launches(kernel_list, {k: v * SPACE_REQUESTS
                                for k, v in eval_want.items()},
                  "the bf16 window")
        rep["bf16_ms"] = [percentile(wall, 50) * 1e3,
                          percentile(wall, 90) * 1e3]
        del model, batches
        gc.collect()
        torch.cuda.empty_cache()

        # the training steps
        state = pstep.build_trainer(cfg_t, mesh, seed=0)
        batches = _camera0_batches(cfg_t, dev)
        grads = _recording_grads(state)
        steps = []
        with deterministic_step():
            for i in range(SPACE_STEPS):
                if i:       # each step from the single device's state
                    state.model.load_state_dict(torch.load(
                        work_dir / f"model{i}.pt", map_location=dev))
                _reset(kernel_list)
                col.STATS.clear()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t = time.perf_counter()
                with (recording_kernel_inputs() if i == 0
                      else contextlib.nullcontext({})) as recorded:
                    metrics = entry.train_step(state, batches[i % 2])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                if i == 0:
                    inputs = recorded
                steps.append(dict(
                    ms=ms, metrics=metrics,
                    launches=_launches(kernel_list, PER_STEP, f"step {i}"),
                    update_gap=_update_gap(state.model, torch.load(
                        work_dir / f"model{i + 1}.pt"), cfg_t.optim, i),
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                    collectives={k: list(v) for k, v in col.STATS.items()}))
                if mesh.rank == 0:
                    torch.save([g.cpu() for g in grads["grads"]],
                               work_dir / f"grads{i}.pt")
        rep["steps"] = steps
        rep["k5_rows"] = inputs["K5"][0][1:]
        del state, batches, grads
        gc.collect()
        torch.cuda.empty_cache()
        rep["replay_err"] = replay_kernels(inputs, dev)
    finally:
        pmesh.release()
    with open(work_dir / f"rank{mesh.rank}.json", "w") as f:
        json.dump(rep, f)
    return 0


def _pooled(want, got, names):
    """JAX's gradient metric (tests/test_parallel.py) per top-level
    module, the render heads apart: the least-squares scale of `got` on
    `want`, sum(a.b) / sum(a.a), and their cosine."""
    from ocrfdet_tpu_torch.train import optim
    groups = {}
    for n, a, b in zip(names, want, got):
        top = n.split(".")[0] + (" (render heads)"
                                 if optim.is_render_param(n) else "")
        a, b = a.double().ravel(), b.double().ravel()
        ab, aa, bb = groups.get(top, (0.0, 0.0, 0.0))
        groups[top] = (ab + float(a @ b), aa + float(a @ a),
                       bb + float(b @ b))
    return {top: (ab / aa, ab / max(np.sqrt(aa * bb), 1e-300))
            for top, (ab, aa, bb) in groups.items() if aa > 1e-20}


def _run_ranks(work_dir: Path, timeout: float):
    """Start the SPACE ranks (`space_rank`) and wait for all of them; if
    one fails, end the others and raise with its log's tail."""
    port = str(_free_port())
    procs = []
    for r in range(SPACE):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(SPACE), LOCAL_WORLD_SIZE=str(SPACE),
                   MASTER_ADDR="localhost", MASTER_PORT=port)
        log_file = open(work_dir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--space-rank",
             str(work_dir)], env=env, stdout=log_file,
            stderr=subprocess.STDOUT), log_file))
    deadline = time.perf_counter() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = [r for r, (p, _) in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.perf_counter() > deadline:
                r = failed[0] if failed else 0
                tail = (work_dir / f"rank{r}.log").read_text()[-6000:]
                raise AssertionError(
                    f"[space] rank {r} "
                    + (f"exited {procs[r][0].returncode}" if failed
                       else f"still running after {timeout:.0f} s")
                    + f":\n{tail}")
            time.sleep(0.5)
        for r, (p, _) in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(
                    f"[space] rank {r} exited {p.returncode}:\n"
                    + (work_dir / f"rank{r}.log").read_text()[-6000:])
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()


def check_space(dev, kernel_list, smi, timeout=600.0):
    """[space]: the `space` axis (parallel/{mesh,collectives,halo}.py, the
    detector's camera blocks, BEV row blocks and render bands) on the
    one card: 2 ranks (`space_rank`, gloo: NCCL refuses two ranks on one
    device) against the single-device port in this process, on the same
    seeded weights and batches.
      * the fp32 eval request (`ocrfdet_config(batch_size=1)` in fp32):
        every head and the aux maps of rank 0 against this process's,
        and the gradients of a fixed functional of them (`probe_grads`,
        the eval path's backward through every kernel and collective,
        averaged over the grid) by JAX's metric per module (the
        factor-1 convention: a gradient counted once per rank reads
        scale 2);
      * SPACE_STEPS fp32 training steps at batch 2 under
        `deterministic_step` on the camera-0 batches
        (`_camera0_batches`), each step of the ranks from the single
        device's state before it: the losses' largest relative
        difference and the averaged gradients by JAX's metric
        (`_pooled` per top-level module: the largest |1 - scale| and 1 -
        cosine, tests/test_parallel.py::test_deep_camera_sharding_raw_
        gradients_match) each within 4 times the floor, the single
        device's distance from itself on the batch with its images moved
        by one rounding up and down (this train-mode step amplifies
        rounding: PERF.md); the parameters after the update within 2.5
        learning rates of the single device's (`_update_gap`);
      * each rank's launches (2 of each of K1-K4 a request, PER_STEP a
        step), every kernel against its plain version on the inputs a
        rank gave it, step ms, peak memory, the collectives' counts and
        bytes, and 20 bf16 requests' median and p90 on the pair and on
        the single device (recorded only: the two ranks share the card).
    Returns {kernel name: dict(launches_space=its launches on rank 0 over
    the steps, max_abs_err_space=its largest error over the ranks)}."""
    import shutil
    import tempfile

    from ocrfdet_tpu_torch import entry, kernels
    from ocrfdet_tpu_torch.bench_train import percentile

    cfg32, cfg_bf, cfg_t = _space_configs(1)
    t0 = time.perf_counter()
    work_dir = Path(tempfile.mkdtemp(dir=kernels.BUILD_DIR,
                                     prefix="space_"))
    try:
        # the single device
        model = entry.build_detector(cfg32, dev, seed=0)
        batch = entry.make_batch(cfg32, seed=0, device=dev)
        preds, aux, _, _ = entry.infer(model, batch)
        probe_names, probe = probe_grads(model, batch)
        ref = dict(preds=[{k: v.cpu() for k, v in t.items()}
                          for t in preds],
                   aux={k: v.cpu() for k, v in aux.items()},
                   probe=[g.cpu() for g in probe])
        del model, preds, aux, probe
        model = entry.build_detector(cfg_bf, dev, seed=0)
        batches = [entry.make_batch(cfg_bf, seed=s, device=dev)
                   for s in range(4)]
        for i in range(3):
            entry.infer(model, batches[i % 4])
        wall = []
        for i in range(SPACE_REQUESTS):
            t = time.perf_counter()
            entry.infer(model, batches[i % 4])
            wall.append(time.perf_counter() - t)
        one_ms = [percentile(wall, 50) * 1e3, percentile(wall, 90) * 1e3]
        del model, batches
        # the single device, and beside it from the same state before
        # each step the single device on the batch with every image
        # pixel moved by one rounding, up and down (the floor: how far
        # rounding alone moves this train-mode step)
        state = entry.build_trainer(cfg_t, dev, seed=0)
        floor = entry.build_trainer(cfg_t, dev, seed=0)
        names = state.optimizer.names["render"] + state.optimizer.names[
            "other"]
        batches = _camera0_batches(cfg_t, dev)
        grads, floor_grads = _recording_grads(state), _recording_grads(floor)
        ref_steps = []
        torch.cuda.reset_peak_memory_stats()
        with deterministic_step():
            for i in range(SPACE_STEPS):
                b = batches[i % 2]
                floors = []
                for eps in (2.0 ** -23, -2.0 ** -23):
                    floor.model.load_state_dict(state.model.state_dict())
                    floor.step = state.step
                    m = entry.train_step(floor, dict(b, imgs=b["imgs"]
                                                     * (1 + eps)))
                    floors.append((m, [g.cpu() for g in
                                       floor_grads["grads"]]))
                torch.cuda.synchronize()
                t = time.perf_counter()
                metrics = entry.train_step(state, b)
                torch.cuda.synchronize()
                ref_steps.append(dict(
                    ms=(time.perf_counter() - t) * 1e3, metrics=metrics,
                    grads=[g.cpu() for g in grads["grads"]], floors=floors))
                torch.save({k: v.cpu() for k, v in
                            state.model.state_dict().items()},
                           work_dir / f"model{i + 1}.pt")
        one_peak = torch.cuda.max_memory_allocated() / 1e9
        del state, floor, batches, grads, floor_grads
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[space] the single device: the fp32 request, {SPACE_REQUESTS}"
            f" bf16 requests (median {one_ms[0]:.3f} ms, p90 "
            f"{one_ms[1]:.3f}), {SPACE_STEPS} steps on the camera-0 "
            f"batches (ms " + ", ".join(f"{s['ms']:.1f}" for s in ref_steps)
            + f"; peak memory {one_peak:.2f} GB with the floor's second "
            f"trainer) in {time.perf_counter() - t0:.1f} s")

        # the two ranks
        t = time.perf_counter()
        _run_ranks(work_dir, timeout)
        reps = [json.loads((work_dir / f"rank{r}.json").read_text())
                for r in range(SPACE)]
        log(f"[space] {SPACE} ranks of the data 1 x space {SPACE} grid on "
            + ", ".join(f"{r['device']} (rank {r['rank']}, s {r['s']})"
                        for r in reps)
            + f" over {reps[0]['backend']} (NCCL refuses two ranks on one "
            f"device) ran in {time.perf_counter() - t:.1f} s; process group "
            f"up in " + ", ".join(f"{r['init_s']:.1f}" for r in reps) + " s")

        # the fp32 request
        got = torch.load(work_dir / "eval.pt")
        errs = {}
        for t_ref, t_got in zip(ref["preds"], got["preds"]):
            for k, v in t_ref.items():
                errs[f"{k}/{len(errs)}"] = (
                    float((t_got[k] - v).abs().max()), float(v.abs().max()))
        for k in ("depth", "semantic", "bev_mask_logit",
                  "opacity_bev_logit"):
            v = ref["aux"][k]
            if tuple(got["aux"][k].shape) != tuple(v.shape):
                raise AssertionError(f"[space] aux {k} shape "
                                     f"{tuple(got['aux'][k].shape)}")
            errs[k] = (float((got["aux"][k] - v).abs().max()),
                       float(v.abs().max()))
        # tolerance: summation order only (the camera sums add two
        # blocks, the BatchNorm-free eval stack sees the same rows):
        # phase 5's kernels-vs-plain bound, 1e-3 of max(1, scale), the
        # depth probabilities 1e-5
        bad = {k: e for k, e in errs.items()
               if e[0] > (1e-5 if k == "depth" else 1e-3 * max(1.0, e[1]))}
        worst = max(errs.items(), key=lambda kv: kv[1][0] / max(1.0,
                                                                 kv[1][1]))
        log(f"[space] fp32 request, rank 0 vs the single device: "
            f"{len(errs)} outputs, largest |diff| / max(1, scale) "
            f"{worst[1][0] / max(1.0, worst[1][1]):.3e} ({worst[0]}: "
            f"{worst[1][0]:.3e} of {worst[1][1]:.3f}); depth "
            f"{errs['depth'][0]:.3e}; launches a rank "
            + json.dumps(reps[0]["eval_launches"]) + ", "
            + json.dumps(reps[1]["eval_launches"]))
        if bad:
            raise AssertionError(f"[space] the fp32 request differs: {bad}")
        # the probe's gradients (the eval path's backward, averaged over
        # the grid): JAX's metric by module; a gradient counted once per
        # rank would read scale 2. Tolerance: |1 - scale| 2e-3, 1 -
        # cosine 1e-4 (other summation orders only; measured 2.2e-4 and
        # 2.1e-6)
        pooled = _pooled(ref["probe"], got["probe"], probe_names)
        dev_scale = max(abs(1 - s) for s, _ in pooled.values())
        dev_cos = max(1 - c for _, c in pooled.values())
        log(f"[space] the probe's gradients (a fixed random functional of "
            f"the fp32 request's heads and maps, every parameter), rank "
            f"0's grid mean vs the single device: {len(pooled)} modules, "
            f"largest |1 - scale| {dev_scale:.3e}, 1 - cosine "
            f"{dev_cos:.3e}")
        if len(pooled) < 8 or dev_scale > 2e-3 or dev_cos > 1e-4:
            raise AssertionError(f"[space] the probe's gradients differ: "
                                 + json.dumps(pooled))

        # the training steps: the losses and the averaged gradients of
        # rank 0 against the single device's, each within 4 times the
        # floor's distance, and the parameters after the update within
        # 2.5 learning rates
        def loss_rel(m, ref):
            return max(abs(m[k] - v) / max(abs(v), 1e-6)
                       for k, v in ref.items())

        def grad_dev(pooled):
            return (max(abs(1 - s) for s, _ in pooled.values()),
                    max(1 - c for _, c in pooled.values()))
        for i, r in enumerate(ref_steps):
            sharded = torch.load(work_dir / f"grads{i}.pt")
            m0, m1 = reps[0]["steps"][i]["metrics"], reps[1]["steps"][i][
                "metrics"]
            if m0 != m1:
                raise AssertionError(f"[space] step {i}: the ranks report "
                                     f"different losses")
            pooled = _pooled(r["grads"], sharded, names)
            off = (loss_rel(m0, r["metrics"]), *grad_dev(pooled))
            base = tuple(np.max([(loss_rel(m, r["metrics"]), *grad_dev(
                _pooled(r["grads"], g, names))) for m, g in r["floors"]],
                axis=0))
            gap = max(rep["steps"][i]["update_gap"] for rep in reps)
            log(f"[space] step {i}: rank 0 against the single device "
                f"(in brackets the floor: the single device on its images "
                f"moved by one rounding, against it): losses' largest"
                f" relative diff {off[0]:.3e} ({base[0]:.3e}); averaged "
                f"gradients by module ({len(pooled)}), largest |1 - scale| "
                f"{off[1]:.3e} ({base[1]:.3e}), 1 - cosine {off[2]:.3e} "
                f"({base[2]:.3e}); loss_total {m0['loss_total']!r} against "
                f"{r['metrics']['loss_total']!r}; the parameters after the "
                f"update within {gap:.3f} learning rates")
            if any(o > 4 * max(b, 1e-6) for o, b in zip(off, base)) \
                    or gap > 2.5:
                raise AssertionError(
                    f"[space] step {i} differs from the single device by "
                    f"more than 4 x the floor: {off} against {base}, update "
                    f"{gap:.3f} learning rates; by module " + json.dumps(
                        pooled))
        for rep in reps:
            steps = rep["steps"]
            coll = steps[-1]["collectives"]
            log(f"[space] rank {rep['rank']}: step ms " + ", ".join(
                f"{s['ms']:.1f}" for s in steps) + " (single device "
                + ", ".join(f"{s['ms']:.1f}" for s in ref_steps)
                + f"); peak memory {max(s['peak_gb'] for s in steps):.2f} "
                f"GB; launches a step {json.dumps(steps[-1]['launches'])}; "
                f"collectives a step (count, MB): " + ", ".join(
                    f"{k} {n} {b / 1e6:.2f}" for k, (n, b) in
                    sorted(coll.items()))
                + f"; K5's tiles and tile columns {rep['k5_rows'][:2]}; "
                f"kernels vs plain on its inputs max_abs_err "
                + json.dumps({k: float(f"{v:.3e}") for k, v in
                              rep["replay_err"].items()}))
        log(f"[space] {SPACE_REQUESTS} bf16 requests (batch 1): the pair "
            f"median {reps[0]['bf16_ms'][0]:.3f} ms p90 "
            f"{reps[0]['bf16_ms'][1]:.3f} (rank 0), the single device "
            f"median {one_ms[0]:.3f} p90 {one_ms[1]:.3f}; recorded only, "
            f"the ranks share the card; nvidia-smi: {smi}")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return {k.name: dict(
        launches_space=sum(s["launches"][k.name] for s in reps[0]["steps"]),
        max_abs_err_space=max(r["replay_err"][k.name] for r in reps))
        for k in kernel_list}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from ocrfdet_tpu_torch import kernels
    from ocrfdet_tpu_torch.config import (geoenh_config, ocrfdet_8f_config,
                                          ocrfdet_config)
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
    # the nine kernel functions and K4's backward binning; launch counts
    # are also checked for K3's backward ordering
    kernel_list, checked = _kernel_lists()
    kernels.build(checked + [cvm.ROW_LOADS_KERNEL, nms.ROWS_KERNEL])
    nms.native_library()
    sources = sorted({k.source for k in kernel_list + [nms.ROWS_KERNEL]})
    log(f"[build] {', '.join(sources)}, K1's load-counting build of "
        f"{cvm.ROW_LOADS_KERNEL.source} (nvcc) and nms.cpp (c++) -> "
        f"{kernels.BUILD_DIR.name}/ in {time.perf_counter() - t:.1f} s")
    eval_kernels = [cvm.KERNEL, bp.KERNEL, htp.KERNEL, ps.KERNEL]

    cfg = ocrfdet_config(batch_size=1)
    lss_cfg = ocrfdet_config(batch_size=1, with_ocrf=False)
    stats = {"cost_volume": check_k1(cfg, dev),
             "bev_pool": check_k2(cfg, dev),
             "ht_pool": check_k3(cfg, dev),
             "point_sample": check_k4(cfg, dev),
             "bev_pool_bwd": check_k2_bwd(cfg, dev),
             "ht_pool_bwd": check_k3_bwd(cfg, dev)}
    stats["point_sample_bwd"], stats["point_sample_order"] = check_k4_bwd(
        cfg, dev)
    torch.cuda.empty_cache()
    nms_rows_stats = check_nms_rows(dev, smi)
    check_slice(lss_cfg, dev, "lss", eval_kernels[:2], checked,
                n_requests=30)
    torch.cuda.empty_cache()
    ocrf_launches = check_slice(cfg, dev, "ocrf", eval_kernels, checked,
                                n_requests=100)
    torch.cuda.empty_cache()
    # per training step: K1 and each forward of K2-K4 once per temporal
    # frame, their backwards (K3's with its ordering, K4's with its
    # binning) and K5 once (the key frame)
    per_step = PER_STEP
    launches, recorded = check_training(dev, checked, per_step)
    torch.cuda.empty_cache()
    stats["composite_tiles"], stats["composite_tiles_bwd"] = check_k5(
        *recorded["K5"][0][:3])
    del recorded
    torch.cuda.empty_cache()
    check_fp32_step(dev, checked)
    torch.cuda.empty_cache()
    check_trainer(dev, checked, eval_kernels, per_step)
    torch.cuda.empty_cache()
    # GeoEnhDet: its kernels at batch 4, its training step (the same
    # launches a step as the flagship's) and its eval path; then the
    # 8-frame eval path (each of K1-K4 once per temporal frame)
    b4 = check_kernels_b4(geoenh_config(), dev)
    torch.cuda.empty_cache()
    check_geoenh_training(dev, checked, per_step)
    # the 1 G-parameter models go before the next window
    gc.collect()
    torch.cuda.empty_cache()
    check_slice(geoenh_config(batch_size=1), dev, "geoenh-eval",
                eval_kernels, checked, n_requests=20)
    gc.collect()
    torch.cuda.empty_cache()
    check_slice(ocrfdet_8f_config(batch_size=1), dev, "8f", eval_kernels,
                checked, n_requests=20)
    gc.collect()
    torch.cuda.empty_cache()
    check_tools(dev, per_step)
    gc.collect()
    torch.cuda.empty_cache()
    check_export(dev, checked, eval_kernels, smi)
    check_ddp(dev, checked, per_step, smi)
    space = check_space(dev, kernel_list, smi)

    rows = []
    for k in kernel_list:
        st = dict(stats[k.name])
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            st.setdefault(f"{key}_b2", st[key])   # measured at batch 2
            if k.name in b4:
                st[f"{key}_b4"] = b4[k.name][key]
        if k.name in b4:
            st["max_abs_err"] = max(st["max_abs_err"],
                                    b4[k.name]["max_abs_err"])
        rows.append(dict(name=k.name, route="cuda",
                         source=f"ocrfdet_tpu_torch/csrc/{k.source}",
                         replaces=k.replaces, launches=launches[k.name],
                         **st, **space[k.name]))
    # the NMS rows kernel: launches a request of the main path's window
    st = dict(nms_rows_stats[1])
    for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
        st[f"{key}_b4"] = nms_rows_stats[4][key]
    rows.append(dict(name=nms.ROWS_KERNEL.name, route="cuda",
                     source=f"ocrfdet_tpu_torch/csrc/{nms.ROWS_KERNEL.source}",
                     replaces=nms.ROWS_KERNEL.replaces,
                     launches_per_request=ocrf_launches["nms_rows"] / 100,
                     **st))
    log(json.dumps({"kernels": rows}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--space-rank"]:
        sys.exit(space_rank(sys.argv[2]))
    sys.exit(main())
