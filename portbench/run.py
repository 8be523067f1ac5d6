#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload flagship-serve-b1 --seed 7 \\
        --seconds 30 --trace 0

Loads the cell's files (see `harness.py`), checks for the cards it
needs, sets up the program with the benchmark's weights and inputs,
measures for `--seconds`, then compares what the timed path produced
with the plain reference and prints, as the last line of standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics), `device`, with `--trace 1` `breakdown`, and last `compared`,
each number that decided `correct` beside its limit (also the last
lines of standard error). With `--control 1` (never in a measured run)
it also reads the control, the reference one precision step down,
against the reference, and prints those numbers on standard error; with
`--fault NAME` it plants one of `faults.py`'s faults in the timed path.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell's files, the run's arguments and the
    device."""
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    control: bool = False
    log: Callable = print


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def metric_values(cell, out: Dict, trace: bool) -> Dict:
    from portbench import harness
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=out["metrics"][m["name"]],
                                      unit=m["unit"])
        return metrics
    for m in cell.per_layer:
        v = harness.reader(m["name"])(out["record"])
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    return metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None,
                    help="plant a fault of faults.py (never in a measured run)")
    args = ap.parse_args(argv)

    from portbench import check, harness
    harness.cache_dirs()
    cell = harness.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    ctx = Ctx(config=cell.config, traffic=cell.traffic, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace),
              device=torch.device("cuda", 0), t_start=T_START,
              control=bool(args.control), log=log)
    if args.fault:
        from portbench import faults
        with faults.planted(args.fault):
            out = harness.driver(cell).run(ctx)
    else:
        out = harness.driver(cell).run(ctx)
    verdict = check.judge(out["readings"], cell.limits)
    device = harness.card(cell.chips)
    device["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    breakdown = None
    if args.trace:
        t = out["record"]["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        breakdown = dict(device_ops=t["device_ops"], idle_gaps=t["idle_gaps"])
        log("record: " + json.dumps({k: v for k, v in out["record"].items()
                                      if k not in ("timings", "trace")}))
    metrics = metric_values(cell, out, bool(args.trace))
    log("readings: " + json.dumps(out["readings"]))
    if out.get("control") is not None:
        log("control: " + json.dumps(out["control"]))
    found = harness.forbidden_modules()
    if found:
        log(f"loaded after the window: {', '.join(found)}")
        return 4
    for name, c in verdict["compared"].items():
        log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(harness.result_line(verdict["correct"], out["attempted"],
                              out["failed"], metrics, device,
                              verdict["compared"], breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
