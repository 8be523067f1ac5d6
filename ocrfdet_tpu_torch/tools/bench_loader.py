"""The host input pipeline's throughput at the real image size
(counterpart of tools_tpu/bench_loader.py).

  python -m ocrfdet_tpu_torch.tools.bench_loader [--samples 16] \\
      [--batches 8] [--batch-size 2] [--workers 1,4,8,16] \\
      [--img-hw 900,1600]

Writes a fake nuScenes (`data/fake_nuscenes.py`) of `--samples` samples
with JPEG images at nuScenes' 900 x 1600 (the decode cost that matters)
into a temporary directory under build/, then times the port's
`data.Loader` end to end for each worker count: PIL decode of 18 images
a sample (2 temporal frames and the stereo reference), the resize, crop,
flip and rotation augmentation, the point-label depth maps, the BEV
masks and the collate, `--batches` batches after one that warms the
pool and the page cache. A host tool: it touches no card. Prints one
JSON line with samples/s per worker count and the host's CPU count.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict

from ..kernels import BUILD_DIR


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--workers", default="1,4,8,16")
    ap.add_argument("--img-hw", default="900,1600")
    args = ap.parse_args(argv)

    from ..config import ocrfdet_config
    from ..data.dataset import Loader, NuScenesDataset
    from ..data.fake_nuscenes import build_fake_nuscenes

    H, W = (int(x) for x in args.img_hw.split(","))
    cfg = ocrfdet_config(batch_size=args.batch_size)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results = {}
    with tempfile.TemporaryDirectory(prefix="bench_loader_",
                                     dir=BUILD_DIR) as root:
        t0 = time.perf_counter()
        pkl = build_fake_nuscenes(root, cfg, n_samples=args.samples,
                                  img_hw=(H, W))
        fixture_s = time.perf_counter() - t0
        print(f"fixture: {args.samples} samples at {H} x {W} in "
              f"{fixture_s:.1f} s", file=sys.stderr)
        ds = NuScenesDataset(cfg, pkl, is_train=True)
        for nw in (int(x) for x in args.workers.split(",")):
            loader = Loader(ds, batch_size=args.batch_size, shuffle=True,
                            num_workers=nw, drop_last=False, prefetch=4)
            it = loader.epoch(0)
            next(it)                   # warm the pool and the page cache
            t0 = time.perf_counter()
            n = 0
            for bi, batch in enumerate(it):
                n += batch["imgs"].shape[0]
                if bi + 1 >= args.batches:
                    break
            dt = time.perf_counter() - t0
            it.close()
            results[nw] = n / dt
            print(f"workers={nw:3d}: {n / dt:6.3f} samples/s "
                  f"({dt / max(n, 1) * 1e3:.0f} ms a sample)",
                  file=sys.stderr)
    result = dict(metric="loader_samples_per_s",
                  value=max(results.values()), unit="samples/s",
                  img_hw=[H, W], samples=args.samples,
                  batches=args.batches, batch_size=args.batch_size,
                  fixture_s=fixture_s, host_cpus=os.cpu_count(),
                  per_workers={str(k): v for k, v in results.items()})
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
