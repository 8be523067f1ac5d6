"""Where the device time of a training step, or of a forward, goes
(counterpart of tools_tpu/profile_step.py).

  python -m ocrfdet_tpu_torch.tools.profile_step [--steps 2] \\
      [--batch-size 2] [--no-ocrf] [--fwd-only] [--topn 40] [--tiny]

Builds the flagship trainer (`ocrfdet_config(batch_size=...)`;
`--no-ocrf`: with_ocrf=False; `--tiny`: `tiny_config`) with seeded
random weights and a synthetic training batch, runs one step outside
the trace, then traces `--steps` steps of `entry.train_step` with
torch.profiler. With `--fwd-only` it traces the eval model's forward on
a request batch of the same size instead, as JAX's `--fwd-only` does.
The trace is read as bench_train.py's `--profile` reads it
(`profile_infer.device_breakdown`): the device's busy time per step
(the union of its kernels' intervals) and idle share, and the device
time by kernel group, here summed into the categories conv/GEMM,
elementwise, BatchNorm, copy/layout, reduce/sort, the hand-written
kernels (K1-K5 and their backwards) and other. Prints the categories
and the `--topn` kernels, then one JSON line. Runs on the card unless
`--device cpu` is given; a CPU trace holds no device time, so its
device numbers are null.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

# profile_infer's kernel groups -> the categories printed here
CATEGORY = {"conv / gemm": "conv/GEMM", "elementwise": "elementwise",
            "batch norm": "BatchNorm", "copy / layout": "copy/layout",
            "reduce / softmax / sort": "reduce/sort"}
KERNELS = "hand-written kernels (K1-K5)"


def category_of(group: str) -> str:
    if group[:1] == "K" and group[1:2].isdigit():
        return KERNELS
    return CATEGORY.get(group, "other")


def build(cfg, batch_size: int, fwd_only: bool, device):
    """step(): one training step of a fresh trainer, or with `fwd_only`
    one eval forward of a fresh detector."""
    import torch

    from .. import entry
    if fwd_only:
        model = entry.build_detector(cfg, device)
        batch = entry.make_batch(cfg, seed=0, batch_size=batch_size,
                                 device=device)

        def step():
            with torch.inference_mode():
                model(batch)
        return step
    state = entry.build_trainer(cfg, device)
    batch = entry.make_batch(cfg, seed=0, batch_size=batch_size,
                             device=device, with_targets=True)

    def step():
        entry.train_step(state, batch)
    return step


def profile(step, steps: int, device, topn: int) -> Dict:
    """Trace `steps` calls of step() (after one outside the trace)."""
    import torch

    from ..profile_infer import device_breakdown
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
    step()
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = dict(wall_ms_per_step=wall_us / steps / 1e3)
    if not cuda:
        return dict(out, device_busy_ms=None, device_idle_share=None,
                    device_events=0, category_ms={}, group_ms={},
                    top_kernels_ms=[])
    br = device_breakdown(prof, steps, wall_us, topn)
    cats: Dict[str, float] = {}
    for group, ms in br["group_ms"].items():
        cat = category_of(group)
        cats[cat] = cats.get(cat, 0.0) + ms
    return dict(out, **br, category_ms=dict(
        sorted(cats.items(), key=lambda kv: -kv[1])))


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--no-ocrf", action="store_true")
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--topn", type=int, default=40)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..config import ocrfdet_config, tiny_config
    from ..entry import resolve_device

    device = resolve_device(args.device)
    cfg = (tiny_config if args.tiny else ocrfdet_config)(
        batch_size=args.batch_size, with_ocrf=not args.no_ocrf)
    step = build(cfg, args.batch_size, args.fwd_only, device)
    result = dict(
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
        config="tiny_config" if args.tiny else "ocrfdet_config",
        with_ocrf=cfg.with_ocrf, mode="forward" if args.fwd_only else "step",
        batch_size=args.batch_size, steps=args.steps,
        **profile(step, args.steps, device, args.topn))
    if result["device_busy_ms"] is not None:
        busy = result["device_busy_ms"]
        print(f"== device busy {busy:.3f} ms a {result['mode']}, idle "
              f"{result['device_idle_share']:.1%} of the traced window ==")
        for cat, ms in result["category_ms"].items():
            print(f"{ms:10.3f} ms  {100 * ms / busy:5.1f}%  {cat}")
        print(f"-- top {args.topn} kernels --")
        for name, ms in result["top_kernels_ms"]:
            print(f"{ms:10.3f} ms  {100 * ms / busy:5.1f}%  {name}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
