"""The host side of evaluation at nuScenes-val scale (counterpart of
tools_tpu/bench_eval_host.py).

  python -m ocrfdet_tpu_torch.tools.bench_eval_host [--samples 300] \\
      [--val-size 6019] [--out build/bench_eval_host.json]

Times the per-sample Scale-NMS as the CPU runs it: the suppression
rows built by the op `ocrfdet::nms_rows` on the CPU (the pair tests in
the C++ library `csrc/nms.cpp`, built with the host's `c++` at first
use), then `ops/nms.py::multi_task_nms`'s scan; and the evaluator
(`core/eval_metrics.py`: accumulate per sample, then one summarize) on
synthetic decoded predictions with the statistics of a
real decode: 6 tasks x 500 candidates, ~8% above the score threshold,
boxes in clusters so that the rotated-IoU suppression has work to do;
12 ground-truth boxes a sample. Extrapolates to the `--val-size` samples
of nuScenes val: per-sample time x val size + one summarize. A host
tool: it touches no card. Prints one JSON line and writes it to `--out`
(`EVAL_HOST_r05.json` at the root is the JAX package's record).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from ..kernels import BUILD_DIR

DEFAULT_OUT = str(BUILD_DIR / "bench_eval_host.json")


def fake_decoded(rng, n_tasks: int = 6, K: int = 500,
                 frac_valid: float = 0.08):
    """One sample's decoded tasks: dict(boxes [K,9], scores, labels,
    valid) per task, JAX's `fake_decoded` draw for draw."""
    tasks = []
    for _ in range(n_tasks):
        boxes = np.zeros((K, 9), np.float32)
        centers = rng.normal(0, 20, (K // 10, 2))
        boxes[:, :2] = (centers[rng.integers(0, K // 10, K)]
                        + rng.normal(0, 1.0, (K, 2)))
        boxes[:, 2] = rng.uniform(-2, 0, K)
        boxes[:, 3:6] = rng.uniform(0.5, 5, (K, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, K)
        boxes[:, 7:9] = rng.normal(0, 2, (K, 2))
        scores = rng.uniform(0, 1, K).astype(np.float32) ** 3
        valid = rng.uniform(0, 1, K) < frac_valid
        labels = rng.integers(0, 2, K)
        tasks.append(dict(boxes=boxes, scores=scores, labels=labels,
                          valid=valid))
    return tasks


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=300)
    ap.add_argument("--val-size", type=int, default=6019)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    from ..config import ocrfdet_config
    from ..core.coder import DecodedBoxes
    from ..core.eval_metrics import DetectionEvaluator
    from ..ops.nms import multi_task_nms, native_library, nms_rows

    cfg = ocrfdet_config()
    rng = np.random.default_rng(0)
    samples = [fake_decoded(rng) for _ in range(args.samples)]
    native_library()                      # the build is not timed

    def host_nms(sample):
        rows = nms_rows([DecodedBoxes(**{k: torch.from_numpy(v[None])
                                         for k, v in task.items()})
                         for task in sample], cfg.head)
        return multi_task_nms(sample, cfg.head,
                              list(rows[:, 0].numpy().view(np.uint64)))

    t0 = time.perf_counter()
    merged = [host_nms(s) for s in samples]
    t_nms = time.perf_counter() - t0

    ev = DetectionEvaluator(cfg.class_names)
    t0 = time.perf_counter()
    for i, m in enumerate(merged):
        gt = np.zeros((12, 9), np.float32)
        gt[:, :2] = rng.uniform(-40, 40, (12, 2))
        gt[:, 3:6] = rng.uniform(1, 5, (12, 3))
        ev.add_sample(m["boxes"], m["scores"], m["labels"], gt,
                      rng.integers(0, 10, 12), token=f"tok{i}")
    t_acc = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = ev.evaluate()
    t_sum = time.perf_counter() - t0

    per_sample_s = (t_nms + t_acc) / args.samples
    result = dict(
        samples=args.samples, val_size=args.val_size,
        nms_ms_per_sample=t_nms / args.samples * 1e3,
        accumulate_ms_per_sample=t_acc / args.samples * 1e3,
        summarize_s=t_sum,
        val_scale_host_s=per_sample_s * args.val_size + t_sum,
        kept_boxes_per_sample=float(np.mean([len(m["scores"])
                                             for m in merged])),
        mAP_on_noise=metrics["mAP"], host_cpus=os.cpu_count())
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
