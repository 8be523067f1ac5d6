#!/usr/bin/env python3
"""Time the PyTorch port's flagship inference request and training step
from several source trees on one NVIDIA GPU, each tree in processes of
its own, interleaved.

    python3 bench_trees.py [--rounds 2] TREE ...

Each TREE is a directory holding a whole `ocrfdet_tpu_torch/` package,
for example a checkout of another commit (`git archive <commit> | tar
-x -C build/parent`); "." is this checkout. Every round runs, for each
tree in turn (A B ... A B ...), two processes from the tree's root, so
that each imports the tree's own package and builds its kernels from
its own sources into its own `build/` (the first round's warm-up pays
for the builds):
- `python -m ocrfdet_tpu_torch.tools.benchmark_infer` (the flagship at
  batch 1: 3 warm-up requests, then 20 timed back to back; forward and
  decode): its ms a request;
- `python -m ocrfdet_tpu_torch.tools.step_variants --variants full`
  (the flagship training step at batch 2: 2 warm-up steps, then 10 timed,
  host clock around each step; the device's busy time of one traced
  step): its median step ms and busy ms.
Prints the card's name and power limit, each reading as it comes, then
one JSON line: per tree, the readings of every round, their median and
their spread (max - min).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PKG = "ocrfdet_tpu_torch"


def run_json(tree: Path, args) -> dict:
    """Run `python -m PKG.tools.<args>` from `tree`; its last stdout line
    as JSON."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    res = subprocess.run([sys.executable, "-m", f"{PKG}.tools.{args[0]}",
                          *args[1:]], cwd=tree, env=env, capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        sys.stderr.write(res.stderr[-4000:])
        raise SystemExit(f"bench_trees: {args[0]} failed in {tree} "
                         f"(exit {res.returncode})")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    trees = [Path(t).resolve() for t in args.trees]
    for t in trees:
        if not (t / PKG / "__init__.py").exists():
            raise SystemExit(f"bench_trees: {t} holds no {PKG}/")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)
    readings = {str(t): {"infer_ms": [], "step_ms": [], "busy_ms": []}
                for t in trees}
    t_start = time.perf_counter()
    for r in range(args.rounds):
        for t in trees:
            inf = run_json(t, ["benchmark_infer", "--iters", "20",
                               "--warmup", "3"])
            step = run_json(t, ["step_variants", "--variants", "full",
                                "--steps", "10", "--warmup", "2",
                                "--out", str(t / "build" / "sv_ab.json")])
            full = step["variants"]["full"]
            got = readings[str(t)]
            got["infer_ms"].append(inf["ms_per_batch"])
            got["step_ms"].append(full["step_ms_median"])
            got["busy_ms"].append(full["busy_ms_per_step"])
            print(f"[round {r}] {t}: request {inf['ms_per_batch']!r} ms, "
                  f"step median {full['step_ms_median']!r} ms (steps "
                  + ", ".join(f"{x:.1f}" for x in full["step_ms"])
                  + f"), busy {full['busy_ms_per_step']!r} ms a step "
                  f"({time.perf_counter() - t_start:.0f} s)", flush=True)
    summary = {}
    for t, got in readings.items():
        summary[t] = {k: dict(runs=v, median=float(np.median(v)),
                              spread=float(np.max(v) - np.min(v)))
                      for k, v in got.items()}
    print(json.dumps({"device": smi, "trees": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
