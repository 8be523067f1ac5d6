"""Where the time of one eval request goes on the card.

    python -m ocrfdet_tpu_torch.profile_infer [--requests 3] [--no-ocrf]

Builds the flagship detector (`ocrfdet_config(batch_size=1)`, OcRF and
HOA on; `--no-ocrf` for the with_ocrf=False slice) with seeded random
weights, answers one warm-up request, then traces `--requests` requests
through `entry.infer` with torch.profiler and prints one JSON line: the
host-clock latency per request and its host NMS part, the device's busy
time per request (union of kernel intervals), its idle share of the
traced window, device time per kernel group, and the ten kernels that
take the most device time. Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from .config import ocrfdet_config
from . import entry

# kernel-name substrings -> group, first match wins
GROUPS = (
    ("K1 cost_volume", ("cost_volume_kernel",)),
    ("K2 bev_pool", ("bev_pool_chunk_kernel", "bev_pool_cells_kernel")),
    ("K2 bev_pool bwd", ("bev_pool_backward_",)),
    ("K3 ht_pool", ("ht_pool_forward_kernel",)),
    ("K3 ht_pool bwd", ("ht_pool_backward_kernel", "ht_pool_count_kernel",
                        "ht_pool_scan_kernel", "ht_pool_place_kernel",
                        "ht_pool_sort_kernel")),
    ("K4 point_sample", ("point_sample_forward_kernel",)),
    ("K4 point_sample bwd", ("point_sample_backward_kernel",
                             "point_sample_count_kernel",
                             "point_sample_place_kernel")),
    ("K5 composite_tiles", ("composite_forward_kernel",)),
    ("K5 composite_tiles bwd", ("composite_backward_kernel",)),
    ("conv / gemm", ("conv", "cudnn", "xmma", "gemm", "cutlass", "implicit",
                     "sm90", "wgrad", "dgrad", "fprop")),
    ("batch norm", ("batch_norm", "bn_fw")),
    ("copy / layout", ("copy", "nchw", "nhwc", "transpose", "permute",
                       "CatArrayBatched", "Memcpy", "Memset")),
    ("index / gather", ("index", "gather", "scatter")),
    ("reduce / softmax / sort", ("reduce", "softmax", "sort", "topk",
                                 "radix")),
    ("elementwise", ("elementwise", "vectorized")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_breakdown(prof, n: int, wall_us: float, topn: int = 10) -> dict:
    """The traced window's device time per unit of work (n units): busy
    time (union of kernel intervals), idle share, events, time per
    kernel group and the `topn` kernels that take the most."""
    by_group = defaultdict(float)
    by_kernel = defaultdict(float)
    intervals = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, e = evt.time_range.start, evt.time_range.end
        intervals.append((s, e))
        by_group[group_of(evt.name)] += e - s
        by_kernel[evt.name] += e - s
    busy = busy_us(intervals)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:topn]
    return dict(
        device_busy_ms=busy / n / 1e3,
        device_idle_share=(1.0 - busy / wall_us) if intervals else None,
        device_events=len(intervals),
        group_ms={g: t / n / 1e3 for g, t in
                  sorted(by_group.items(), key=lambda kv: -kv[1])},
        top_kernels_ms=[(k[:80], t / n / 1e3) for k, t in top])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--no-ocrf", action="store_true",
                    help="the with_ocrf=False (LSS) slice")
    args = ap.parse_args(argv)
    cfg = ocrfdet_config(batch_size=1, with_ocrf=not args.no_ocrf)
    model = entry.build_detector(cfg)
    batches = [entry.make_batch(cfg, seed=s) for s in range(args.requests)]
    entry.infer(model, batches[0])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    nms_s = 0.0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches:
            timings = {}
            entry.infer(model, b, timings=timings)
            nms_s += timings["nms"]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n = args.requests
    out = dict(
        device=torch.cuda.get_device_name(0),
        with_ocrf=cfg.with_ocrf, compute_dtype=cfg.compute_dtype,
        requests=n, latency_ms=wall_us / n / 1e3,
        host_nms_ms=nms_s / n * 1e3,
        **device_breakdown(prof, n, wall_us))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
