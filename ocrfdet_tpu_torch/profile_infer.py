"""Where the time of one eval request goes on the card.

    python -m ocrfdet_tpu_torch.profile_infer [--requests 3] [--no-ocrf]
        [--batch-size 1] [--span-cost 200]

Builds the flagship detector (`ocrfdet_config(batch_size=...)`, OcRF and
HOA on; `--no-ocrf` for the with_ocrf=False slice) with seeded random
weights, answers one warm-up request, then traces `--requests` requests
through `entry.infer` with torch.profiler and prints one JSON line: the
host-clock latency per request and its host NMS part, the device's busy
time per request (union of kernel intervals), its idle share of the
traced window, device time per kernel group and per stage of the
request (`stage_ms`: each kernel under the innermost `ocrfdet.` span of
`utils/spans.py` above the CPU op that launched it), and the ten kernels
that take the most device time. The OcRF view transformer replays its
CUDA graph there (models/detector.py): the profiler ties the replayed
kernels to no CPU op, so `stage_ms` leaves them out (the busy time and
the groups count them; busy minus the stages is the view transformer's
device time), and its eight `ocrfdet.vt.*` parts record only where it
runs eagerly. `--span-cost N` adds what the span
recorder costs: N requests' forward and decode issued, alternately with
a recorder active and without, each timed on the host clock from
outside (medians), and one `span()` with nothing on and with a recorder
on, in ns (a loop on the host). Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict
from contextlib import nullcontext

import torch

from .config import ocrfdet_config
from . import entry
from .core.coder import decode_all_tasks
from .utils import spans

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


SPAN_PREFIX = "ocrfdet."
OUTSIDE = "outside any ocrfdet. span"


def stage_of(evt) -> str:
    """The innermost `ocrfdet.` span at or above the CPU event `evt`."""
    while evt is not None:
        if evt.name.startswith(SPAN_PREFIX):
            return evt.name
        evt = evt.cpu_parent
    return OUTSIDE


def stage_us(events) -> dict:
    """Device time (us) of the kernels each CPU op launched, by the
    innermost `ocrfdet.` span above that op."""
    by_stage = defaultdict(float)
    for evt in events:
        if evt.device_type == torch.autograd.DeviceType.CPU and evt.kernels:
            by_stage[stage_of(evt)] += sum(k.duration for k in evt.kernels)
    return by_stage


def device_breakdown(prof, n: int, wall_us: float, topn: int = 10) -> dict:
    """The traced window's device time per unit of work (n units): busy
    time (union of kernel intervals; ranges that the profiler draws on
    the device's timeline are no kernels), idle share, events, time per
    kernel group and per stage (`stage_us`), and the `topn` kernels that
    take the most."""
    by_group = defaultdict(float)
    by_kernel = defaultdict(float)
    intervals = []
    events = prof.events()
    for evt in events:
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
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
        stage_ms={g: t / n / 1e3 for g, t in
                  sorted(stage_us(events).items(), key=lambda kv: -kv[1])},
        top_kernels_ms=[(k[:80], t / n / 1e3) for k, t in top])


def span_ns(loops: int = 200_000) -> float:
    """Host ns of one `with span(...)` beyond an empty loop's step."""
    t0 = time.perf_counter()
    for _ in range(loops):
        with spans.span("ocrfdet.cost"):
            pass
    t1 = time.perf_counter()
    for _ in range(loops):
        pass
    return ((t1 - t0) - (time.perf_counter() - t1)) / loops * 1e9


@torch.inference_mode()
def span_cost(model, batches, n: int) -> dict:
    """Median host ms of issuing the forward and the decode with a
    recorder active and without (n requests, on and off in the order
    on off off on, the card idle at each start), and one span's ns."""
    times = dict(on=[], off=[])
    for i in range(n):
        on = i % 4 in (0, 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with spans.recording() if on else nullcontext():
            preds, _ = model(batches[i % len(batches)])
            decode_all_tasks(preds, model.cfg.head, model.cfg.grid)
        times["on" if on else "off"].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    on, off = (statistics.median(times[k]) * 1e3 for k in ("on", "off"))
    off_ns = span_ns()
    with spans.recording():
        on_ns = span_ns()
    return dict(requests=n, dispatch_on_ms=on, dispatch_off_ms=off,
                on_cost_share=on / off - 1.0, span_off_ns=off_ns,
                span_on_ns=on_ns)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--no-ocrf", action="store_true",
                    help="the with_ocrf=False (LSS) slice")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--span-cost", type=int, default=0, metavar="N",
                    help="time N requests' dispatch with the recorder on "
                    "and off")
    args = ap.parse_args(argv)
    cfg = ocrfdet_config(batch_size=args.batch_size,
                         with_ocrf=not args.no_ocrf)
    model = entry.build_detector(cfg)
    batches = [entry.make_batch(cfg, seed=s, batch_size=args.batch_size)
               for s in range(args.requests)]
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
    if args.span_cost:
        out["span_cost"] = span_cost(model, batches, args.span_cost)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
