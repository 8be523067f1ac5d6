"""Helpers of the benchmark's tests: the drivers run on the CPU at the
tiny configuration, skipping the harness's look for a card."""
import json
import time
from pathlib import Path

import torch

from portbench import check
from portbench.run import Ctx

HERE = Path(__file__).resolve().parent
# the tiny model with the flagship's decode and NMS sizes: enough
# candidates a task that the NMS suppresses some
TINY = {"function": "tiny_config", "overrides": {"head": {
    "max_num": 256, "pre_max_size": 1000, "post_max_size": 83}}}
SEED = 2 ** 31 + 4242


def limits(cell: str):
    return json.loads((HERE.parent / "limits" / f"{cell}.json").read_text())


def serve_ctx(batch=1, control=False, seconds=2.0, seed=SEED):
    return Ctx(config=TINY, traffic={
        "driver": "serve", "batch": batch, "inputs": 3, "warmup": 1,
        "forward_m": [0.0, 7.5], "yaw_rad": [-0.1, 0.1], "sample": 2,
        "traced": 2, "untraced_share": 0.67},
        seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"),
        t_start=time.perf_counter(), control=control, log=lambda m: None)


def verdict(readings, cell):
    return check.judge(readings, limits(cell))
