"""Inference throughput (counterpart of tools_tpu/benchmark_infer.py,
the reference's tools/analysis_tools/benchmark.py: warm-up, then timed
frames/s with the data time left out).

  python -m ocrfdet_tpu_torch.tools.benchmark_infer [--batch-size 1] \\
      [--iters 20] [--warmup 3] [--tiny] [--device cuda]

Builds the flagship detector (`ocrfdet_config`; `--tiny`: `tiny_config`)
with seeded random weights and one synthetic request batch, runs the
eval forward and the box decode (`decode_all_tasks`) `--warmup` times,
then `--iters` times back to back in a timed window that ends in
`torch.cuda.synchronize()`. No host NMS, as the JAX tool decodes in
graph and runs none (`entry.infer` adds the copy to the host and NMS).
Prints one JSON line: frames/s (batch x iters / the window's wall time),
ms per batch and the device's name. Runs on the card unless `--device
cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .. import entry
    from ..config import ocrfdet_config, tiny_config
    from ..core.coder import decode_all_tasks

    device = entry.resolve_device(args.device)
    cfg = (tiny_config if args.tiny else ocrfdet_config)(
        batch_size=args.batch_size)
    model = entry.build_detector(cfg, device)
    batch = entry.make_batch(cfg, seed=0, batch_size=args.batch_size,
                             device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @torch.inference_mode()
    def infer():
        preds, _ = model(batch)
        return decode_all_tasks(preds, cfg.head, cfg.grid)

    for _ in range(args.warmup):
        infer()
    sync()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = infer()
    sync()
    dt = time.perf_counter() - t0
    result = dict(
        frames_per_s=args.batch_size * args.iters / dt,
        ms_per_batch=dt / args.iters * 1e3, batch_size=args.batch_size,
        iters=args.iters, warmup=args.warmup,
        config="tiny_config" if args.tiny else "ocrfdet_config",
        tasks=len(out),
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
