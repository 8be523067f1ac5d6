"""Serving traffic: a closed loop of one client through the port's
`entry.infer` (the forward, the decode, the copy of the boxes to the
host and the host NMS), one batch of `batch` samples a request, cycling
over `inputs` distinct inputs drawn from the seed.

Parameters (traffic file): batch, inputs, warmup (requests before the
window), forward_m and yaw_rad (each sample's ego motion), sample (the
requests kept for the comparison, a reservoir drawn from the seed over
the whole window), traced (requests under the profiler in a
`--trace 1` run), untraced_share (the part of a traced run's window
timed without the profiler).
"""
from __future__ import annotations

import random
import time
from typing import Dict

import numpy as np
import torch

from .. import check, gen, harness, refrun, stats, trace, weights, work


def setup(ctx) -> Dict:
    """The program's eval model with the benchmark's weights, the
    inputs, and the warm-up."""
    from ocrfdet_tpu_torch import entry
    tr, dev = ctx.traffic, ctx.device
    cfg = harness.program_config(ctx.config, batch_size=tr["batch"])
    rcfg = harness.reference_config(ctx.config, batch_size=tr["batch"],
                                    compute_dtype="float32")
    model = weights.build(entry.detector_class(cfg), cfg).to(dev)
    weights.load(model, weights.draw(refrun.structure(rcfg), ctx.seed, dev))
    model.eval()
    inputs = [gen.make_input(cfg, tr["batch"], ctx.seed, i, dev,
                             tr["forward_m"], tr["yaw_rad"])
              for i in range(tr["inputs"])]
    for i in range(tr["warmup"]):
        entry.infer(model, inputs[i % len(inputs)])
    harness.sync(dev)
    return dict(model=model, inputs=inputs, cfg=cfg, rcfg=rcfg)


def window(ctx, state, seconds: float, keep, timings=None) -> Dict:
    """Closed-loop requests until `seconds` have passed; each latency
    from handing over the batch to the detections on the host."""
    from ocrfdet_tpu_torch import entry
    model, inputs = state["model"], state["inputs"]
    lat = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = state.get("next", 0)
    t1 = t0
    while t1 < deadline:
        tm = {} if timings is not None else None
        ts = time.perf_counter()
        preds, aux, _, dets = entry.infer(model, inputs[i % len(inputs)],
                                          timings=tm)
        t1 = time.perf_counter()
        lat.append(t1 - ts)
        if timings is not None:
            timings.append(tm)
        keep(i, preds, aux["depth"], dets)
        i += 1
    state["next"] = i
    return dict(latencies=lat, wall=t1 - t0, requests=len(lat))


class Reservoir:
    """`k` requests drawn uniformly from the seed over the window."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def __call__(self, i, preds, depth, dets):
        self.seen += 1
        item = (i, preds, depth, dets)
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def run(ctx) -> Dict:
    tr, dev = ctx.traffic, ctx.device
    t_setup = time.perf_counter()
    state = setup(ctx)
    t_window = time.perf_counter()
    setup_s = t_window - ctx.t_start
    harness.reset_peak(dev)
    res = Reservoir(tr["sample"], ctx.seed)
    B = tr["batch"]
    rec: Dict = dict(batch=B)
    timings = []
    if not ctx.trace:
        w = window(ctx, state, ctx.seconds, res)
    else:
        w = window(ctx, state, ctx.seconds * tr["untraced_share"], res,
                   timings)
        rec.update(timings=timings, samples_untraced=w["requests"] * B,
                   wall_untraced=w["wall"])
        traced_idx = traced_window(ctx, state, rec)
    peak = harness.peak_bytes(dev)
    lat = w["latencies"]
    metrics = {
        "serve_p95_ms": stats.percentile(lat, 95) * 1e3,
        "serve_frames_per_s": stats.rate(w["requests"] * B, w["wall"]),
        "peak_mem_gib": peak / 2 ** 30,
        "setup_s": setup_s,
    }
    ctx.log(f"window: {w['requests']} requests in {w['wall']:.3f} s, "
            f"median {stats.median(lat) * 1e3:.3f} ms; set-up {setup_s:.3f} s, "
            f"{t_window - t_setup:.3f} s of it in the driver")
    # the program's state goes before the reference runs
    samples = [(i, preds, depth, dets) for i, preds, depth, dets in res.items]
    keep_inputs = {i % len(state["inputs"]) for i, *_ in samples}
    if ctx.trace:
        keep_inputs |= set(traced_idx)
    inputs = {i: state["inputs"][i] for i in keep_inputs}
    state_rcfg = state["rcfg"]
    del state, res
    harness.free(dev)
    readings, control = reference(ctx, state_rcfg, samples, inputs, rec)
    return dict(metrics=metrics, record=rec, readings=readings,
                control=control, attempted=w["requests"], failed=0,
                memory_peak_bytes=peak)


def traced_window(ctx, state, rec):
    """A few requests under the profiler, with the benchmark's spans and
    CUDA events around K1's op; returns the inputs they used."""
    tr = ctx.traffic
    ev = trace.OpEvents()
    start = state["next"]
    from ocrfdet_tpu_torch.ops import cost_volume as k1
    with trace.patched("ocrfdet_tpu_torch.ops.cost_volume:cost_volume",
                       ev.wrap("k1")), \
            trace.patched_attr(k1.KERNEL, "launch", ev.wrap("k1_launch")), \
            trace.patched("ocrfdet_tpu_torch.entry:multi_task_nms",
                          trace.span("portbench.host_nms")), \
            trace.patched("ocrfdet_tpu_torch.entry:decode_all_tasks",
                          trace.span("portbench.decode")), \
            trace.module_span(state["model"], "portbench.forward"), \
            trace.profile() as prof:
        with torch.profiler.record_function(trace.WINDOW):
            from ocrfdet_tpu_torch import entry
            for n in range(tr["traced"]):
                i = state["next"]
                with torch.profiler.record_function("portbench.request"):
                    entry.infer(state["model"],
                                state["inputs"][i % len(state["inputs"])])
                state["next"] = i + 1
            torch.cuda.synchronize()
    t = trace.read(prof)
    rec["trace"] = t
    rec["k1_event_s"] = ev.seconds("k1")
    rec["k1_profiler_s"] = t["range_device_s"].get("ocrfdet::cost_volume")
    rec["k1_launch_event_s"] = ev.seconds("k1_launch")
    rec["k1_device_s"], rec["k1_time_from"] = trace.device_seconds(
        rec["k1_profiler_s"], rec["k1_launch_event_s"])
    rec["k1_calls"] = len(ev.calls["k1"])
    n_in = len(state["inputs"])
    idx = [i % n_in for i in range(start, state["next"])]
    rec["traced_inputs"] = idx
    return idx


def reference(ctx, rcfg, samples, inputs, rec):
    """The sampled requests against the reference (and, for the control
    runs, the control against the reference); in a traced run also the
    reference's FLOPs a sample and K1's work on the traced inputs."""
    dev = ctx.device
    ref = refrun.build_eval(rcfg, ctx.seed, dev)
    n_in = ctx.traffic["inputs"]
    counter = refrun.Counter() if ctx.trace else None
    cache = {}

    def ref_out(j):
        if j not in cache:
            if counter is not None:
                n0 = {k: len(v) for k, v in counter.calls.items()}
                f0 = counter.flops()
                with counter.counting():
                    cache[j] = refrun.serve(ref, inputs[j], dev)
                cache[(j, "flops")] = counter.flops() - f0
                cache[(j, "k1")] = counter.calls["k1"][n0.get("k1", 0):]
            else:
                cache[j] = refrun.serve(ref, inputs[j], dev)
        return cache[j]
    prog = check.ServeReadings(rcfg.head, rcfg.grid)
    ctl = check.ServeReadings(rcfg.head, rcfg.grid) if ctx.control else None
    for i, preds, depth, dets in samples:
        j = i % n_in
        r_preds, r_depth, _ = ref_out(j)
        prog.add(preds, depth, dets, r_preds, r_depth)
        if ctl is not None:        # the control serves in the program's place
            c = refrun.serve(ref, inputs[j], dev, mode="control",
                             detections=True)
            ctl.add(*c, r_preds, r_depth)
    if ctx.trace:
        B = ctx.traffic["batch"]
        for j in rec["traced_inputs"]:
            ref_out(j)
        per_input = [cache[(j, "flops")] for j in sorted({*rec["traced_inputs"]})]
        rec["ref_flops_per_sample"] = float(np.mean(per_input)) / B
        rec["k1_bound_s"] = sum(work.bound_s(w) for j in rec["traced_inputs"]
                                for w in cache[(j, "k1")])
    return prog.numbers(), (ctl.numbers() if ctl is not None else None)
