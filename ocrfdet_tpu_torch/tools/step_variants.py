"""Attribute the flagship training step's time by variants (counterpart
of tools_tpu/step_variants.py).

  python -m ocrfdet_tpu_torch.tools.step_variants \\
      [--variants full,no_stereo,no_ocrf,ablate_sample] [--steps 10] \\
      [--warmup 2] [--batch-size 2] [--out build/step_variants.json]

Variants of `ocrfdet_config(batch_size=...)` (`--tiny`: `tiny_config`):
  full         the flagship step
  no_stereo    use_stereo=False: no cost volume (K1)
  no_ocrf      with_ocrf=False: no OcRF branch (K3, K4, K5, HOA, the
               renders and their losses)
  no_temporal  num_adj=0: one frame
  ablate_<a>+<b>  the `vt.ablate` profiling seams a, b, ... of the OcRF
               view transformer (nerf, render, sample, hoa, splat,
               nerfcomp)
Each variant gets its own trainer (seeded random weights) and two
training batches. The host's noise moves a step's time by up to 2x
between windows, so the variants run interleaved, one step each in
turn (A B C A B C ...), in one process: `--warmup` rounds, then
`--steps` timed rounds. For each variant it reports the median step
time (host clock around `entry.train_step`, which ends in the guard's
host read), the device's busy time per step from a torch.profiler
trace of one more step (bench_train.py's reading: the union of the
kernels' intervals), both as deltas against `full`, the launches of
each hand-written kernel per step, and the last loss. It prints one
JSON line and writes it to `--out`. Runs on the card unless `--device
cpu` is given; on the CPU no device time exists, and the busy time and
its delta are null.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List

import numpy as np

from ..kernels import BUILD_DIR
from ..models.ocrf.view_transformer_ocrf import SEAMS

DEFAULT_OUT = str(BUILD_DIR / "step_variants.json")


def variant_config(name: str, batch_size: int, tiny: bool = False):
    """The config of variant `name` (see the module's docstring)."""
    from ..config import ocrfdet_config, tiny_config
    make = tiny_config if tiny else ocrfdet_config
    cfg = make(batch_size=batch_size)
    if name == "full":
        return cfg
    if name == "no_stereo":
        return dataclasses.replace(cfg, use_stereo=False)
    if name == "no_ocrf":
        return make(batch_size=batch_size, with_ocrf=False)
    if name == "no_temporal":
        return dataclasses.replace(cfg, num_adj=0)
    if name.startswith("ablate_"):
        seams = tuple(name[len("ablate_"):].split("+"))
        if set(seams) - set(SEAMS):
            raise ValueError(f"variant {name!r}: the seams are {SEAMS}")
        return dataclasses.replace(cfg, vt=dataclasses.replace(
            cfg.vt, ablate=seams))
    raise ValueError(f"unknown variant {name!r}")


def path_kernels() -> List:
    """Every hand-written kernel the training step can launch, with K3's
    backward ordering and K4's backward binning."""
    from ..ops import bev_pool as bp
    from ..ops import cost_volume as cvm
    from ..ops import ht_pool as htp
    from ..ops import point_sample as ps
    from ..ops.splat import composite as ct
    return [cvm.KERNEL, bp.KERNEL, bp.BWD_KERNEL, htp.KERNEL,
            htp.BWD_KERNEL, htp.ORDER_KERNEL, ps.KERNEL, ps.BWD_KERNEL,
            ps.ORDER_KERNEL, ct.KERNEL, ct.BWD_KERNEL]


def run(names, steps: int, warmup: int, batch_size: int, device,
        tiny: bool = False) -> Dict[str, Dict]:
    """The variants `names`, interleaved; {name: result} (see the
    module's docstring)."""
    import torch

    from .. import entry
    from ..profile_infer import device_breakdown

    cuda = device.type == "cuda"
    kernels = path_kernels()
    runs = {}
    for name in names:
        cfg = variant_config(name, batch_size, tiny)
        runs[name] = dict(
            state=entry.build_trainer(cfg, device, seed=0),
            batches=[entry.make_batch(cfg, seed=s, batch_size=batch_size,
                                      device=device, with_targets=True)
                     for s in range(2)],
            times=[], launches={k.name: 0 for k in kernels}, metrics={})

    def one_step(r, i, timed):
        for k in kernels:
            k.launches = 0
        t = time.perf_counter()
        r["metrics"] = entry.train_step(r["state"], r["batches"][i % 2])
        if timed:
            r["times"].append(time.perf_counter() - t)
            for k in kernels:
                r["launches"][k.name] += k.launches
    for i in range(warmup + steps):
        for name in names:
            one_step(runs[name], i, timed=i >= warmup)

    out = {}
    for name in names:
        r = runs[name]
        busy = None
        if cuda:
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                entry.train_step(r["state"], r["batches"][0])
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy = device_breakdown(prof, 1, wall_us)["device_busy_ms"]
        m = r["metrics"]
        out[name] = dict(
            step_ms_median=float(np.median(r["times"])) * 1e3,
            step_ms=[t * 1e3 for t in r["times"]],
            busy_ms_per_step=busy,
            launches_per_step={k: n / steps
                               for k, n in r["launches"].items()},
            loss_total=m["loss_total"],
            skipped=m["skipped_nonfinite"])
        del runs[name]["state"]
    if "full" in out:
        base = out["full"]
        for name, v in out.items():
            if name == "full":
                continue
            v["delta_ms_vs_full"] = (base["step_ms_median"]
                                     - v["step_ms_median"])
            v["delta_busy_ms_vs_full"] = (
                None if v["busy_ms_per_step"] is None
                else base["busy_ms_per_step"] - v["busy_ms_per_step"])
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="full,no_stereo,no_ocrf")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..entry import resolve_device
    device = resolve_device(args.device)
    names = args.variants.split(",")
    for name in names:            # a typo fails before anything is built
        variant_config(name, args.batch_size, args.tiny)
    variants = run(names, args.steps, args.warmup, args.batch_size, device,
                   args.tiny)
    result = dict(
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
        batch_size=args.batch_size, steps=args.steps, warmup=args.warmup,
        config="tiny_config" if args.tiny else "ocrfdet_config",
        variants=variants)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
