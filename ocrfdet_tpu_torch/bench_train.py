"""Time the flagship training step on the card (the port's counterpart of
`bench.py::bench_train`).

    python -m ocrfdet_tpu_torch.bench_train --steps 10 --batch-size 2
    python -m ocrfdet_tpu_torch.bench_train --profile 3

Builds the trainer of `ocrfdet_config()` (bf16 conv towers, OcRF + HOA
and the render branch, seeded random weights), makes two synthetic
training batches (`make_batch(with_targets=True)`, seeds 0 and 1), runs
3 warm-up steps and then `--steps` timed steps over them, one at a
time, each ending in the guard's host read (a device sync). Prints one
JSON line: frames/s (samples x steps / wall time of the timed steps),
the median and p90 step time, the peak device memory
(`torch.cuda.max_memory_allocated` over the timed steps), the last
step's loss dict, the skipped steps and the card's name. With
`--profile N` it then traces N more steps with torch.profiler and adds
the device's busy time per step, its idle share of the traced window and
the device time per kernel group (profile_infer.py's grouping); the
profiler slows the host, so that idle share overstates the untraced one.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch

from . import entry
from .config import ocrfdet_config
from .profile_infer import device_breakdown

WARMUP = 3          # steps before the timed window
N_BATCHES = 2       # training batches the steps cycle over


def percentile(xs, q: float) -> float:
    """The q-th percentile of xs (nearest rank)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, round(q / 100 * len(xs)) - 1))]


def run(cfg, steps: int, batch_size: int) -> Dict:
    """Train `steps` timed steps after WARMUP on the card; returns the
    trainer state and the window's numbers."""
    state = entry.build_trainer(cfg)
    batches = [entry.make_batch(cfg, seed=s, batch_size=batch_size,
                                with_targets=True)
               for s in range(N_BATCHES)]
    for i in range(WARMUP):
        entry.train_step(state, batches[i % N_BATCHES])
    return window(state, batches, steps)


def window(state, batches, steps: int) -> Dict:
    """`steps` timed training steps of `state` over `batches`."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times: List[float] = []
    metrics: Dict[str, float] = {}
    skipped = 0.0
    t0 = time.perf_counter()
    for i in range(steps):
        t = time.perf_counter()
        metrics = entry.train_step(state, batches[i % len(batches)])
        times.append(time.perf_counter() - t)
        skipped += metrics["skipped_nonfinite"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    B = batches[0]["imgs"].shape[0]
    return dict(state=state, steps=steps, batch_size=B,
                frames_per_s=B * steps / wall, wall_s=wall,
                step_ms_median=percentile(times, 50) * 1e3,
                step_ms_p90=percentile(times, 90) * 1e3,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                skipped=skipped, metrics=metrics)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many more steps with torch.profiler")
    args = ap.parse_args()
    cfg = ocrfdet_config(batch_size=args.batch_size)
    r = run(cfg, args.steps, args.batch_size)
    out = {k: r[k] for k in ("steps", "batch_size", "frames_per_s", "wall_s",
                             "step_ms_median", "step_ms_p90", "peak_mem_gb",
                             "skipped")}
    if args.profile:
        batch = entry.make_batch(cfg, seed=0, batch_size=args.batch_size,
                                 with_targets=True)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.profile):
                entry.train_step(r["state"], batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        out["profiled_step_ms"] = wall_us / args.profile / 1e3
        out.update(device_breakdown(prof, args.profile, wall_us))
    out["loss_total"] = r["metrics"]["loss_total"]
    out["losses"] = {k: v for k, v in r["metrics"].items()
                     if k not in ("loss_total", "skipped_nonfinite")}
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0 if np.isfinite(out["loss_total"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
