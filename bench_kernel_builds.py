#!/usr/bin/env python3
"""Time builds of the PyTorch port's K4 forward and K5 backward from other
source trees against this checkout's, on one NVIDIA GPU.

    python3 bench_kernel_builds.py TREE [TREE ...]

Each TREE is a directory holding `ocrfdet_tpu_torch/csrc/` with
`point_sample.cu`, `composite_tiles.cu` or both: a checkout of another
commit (`git archive <commit> ocrfdet_tpu_torch/csrc | tar -x -C
build/parent`) or a copy with an edited source. Every build is first
held to the plain version (K4 bit for bit, K5 per stream at rtol 1e-4,
atol 1e-5 x the stream's scale, as chip_smoke.check_k5), then timed
A B B A: in the order checkout, trees, then in reverse, the mean of the
two readings, each `chip_smoke.device_ms` (device time per call from
torch.profiler):
- K4's forward at batch 2 with C = 4, on 16-byte aligned maps and on
  maps 4 bytes past that alignment (the launcher sends those to the
  scalar form), and at batch 1 with C = 1, beside `F.grid_sample`;
- K5's backward on the streams of one flagship training step at batch
  2 (recorded as chip_smoke records them), with random cotangents.
A tree whose K5 backward takes no crossing slot (sources from before the
forward wrote one) is called without it. Prints the card's name and
power limit, then one JSON line of the readings.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from chip_smoke import close, device_ms, log


def abba(cases: dict, reps: int) -> dict:
    """Device ms of each of `cases` (name: fn), timed in the order of the
    dict and then in reverse, the mean of the two."""
    names = list(cases)
    t = {n: [] for n in names}
    for n in names + names[::-1]:
        t[n].append(device_ms(cases[n], reps))
    return {n: float(np.mean(v)) for n, v in t.items()}


def build_of(base, tree: str):
    """`base` (a kernels.Kernel) built from TREE's copy of its source, or
    None if TREE has none."""
    from ocrfdet_tpu_torch import kernels
    path = Path(tree).resolve() / "ocrfdet_tpu_torch" / "csrc" / base.source
    if not path.exists():
        return None
    argtypes = base.argtypes
    if base.symbol == "composite_tiles_backward" and not re.search(
            r"composite_tiles_backward\([^)]*\bcross\b", path.read_text()):
        argtypes = argtypes[:5] + argtypes[6:]      # no crossing slot
    return kernels.Kernel(name=f"{base.name} ({tree})", source=str(path),
                          symbol=base.symbol, argtypes=argtypes,
                          replaces=base.replaces)


def time_k4(dev, builds: dict) -> dict:
    import torch.nn.functional as F
    from ocrfdet_tpu_torch import kernels
    from ocrfdet_tpu_torch.config import ocrfdet_config
    from ocrfdet_tpu_torch.ops import point_sample as ps

    results = {}
    cfg = ocrfdet_config(batch_size=1)
    for B, C in ((2, 4), (1, 1)):
        maps, px, py = chip_smoke.k4_inputs(cfg, dev, B, C)
        BN, H, W, _ = maps.shape
        shifted = torch.empty(maps.numel() + 1, device=dev)[1:].view(
            maps.shape)
        shifted.copy_(maps)
        want = ps.point_sample_points_plain(maps, px, py)
        out = torch.empty_like(want)

        def run(k, m):
            return lambda: k.launch(
                kernels.ptr(m), kernels.ptr(px), kernels.ptr(py),
                kernels.ptr(out), BN, H, W, C, px.shape[1],
                kernels.stream_of(m))
        cases = {}
        for name, k in builds.items():
            cases[name] = run(k, maps)
            if C == 4:
                cases[f"{name}, maps 4 bytes off"] = run(k, shifted)
        for name, fn in cases.items():
            out.zero_()
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"K4 {name} differs from the plain "
                                     f"version")
        grid = torch.stack([(2 * px + 1) / W - 1, (2 * py + 1) / H - 1],
                           -1)[:, None]
        maps_nchw = maps.permute(0, 3, 1, 2).contiguous()
        cases["F.grid_sample"] = lambda: F.grid_sample(
            maps_nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False)
        key = f"k4 forward batch {B} C={C}"
        results[key] = abba(cases, reps=50)
        log(f"[builds] {key} ms: {results[key]}")
    return results


def time_k5(dev, builds: dict) -> dict:
    from ocrfdet_tpu_torch import entry, kernels
    from ocrfdet_tpu_torch.config import ocrfdet_config
    from ocrfdet_tpu_torch.ops.splat import composite as ct

    cfg = ocrfdet_config(batch_size=2)
    state = entry.build_trainer(cfg, dev, seed=0)
    batch = entry.make_batch(cfg, seed=0, batch_size=2, device=dev,
                             with_targets=True)
    with chip_smoke.recording_k5() as rec:
        entry.train_step(state, batch)
    del state, batch
    torch.cuda.empty_cache()
    attrs = rec["attrs"]
    T, n_tx = rec["dims"][:2]
    prgb, _, _, pcross = ct.composite_forward_plain(attrs, T, n_tx, 16, 16)
    gen = torch.Generator(device=dev).manual_seed(15)
    g_rgb = torch.randn(prgb.shape, generator=gen, device=dev)
    g_med = torch.randn(prgb.shape[:2], generator=gen, device=dev)
    g_logt = torch.randn(prgb.shape[:2], generator=gen, device=dev)
    pointers = [kernels.ptr(x) for x in (attrs, prgb, g_rgb, g_logt, g_med,
                                         pcross)]
    pd = ct.composite_backward_plain(attrs, prgb, g_rgb, g_logt, g_med,
                                     pcross, T, n_tx, 16, 16)

    def bwd(k):
        d = torch.empty_like(attrs)
        ins = pointers if len(k.argtypes) == 13 else pointers[:5]
        k.launch(*ins, kernels.ptr(d), attrs.shape[0], T, attrs.shape[1],
                 n_tx, 16, kernels.stream_of(attrs))
        return d
    for name, k in builds.items():
        d = bwd(k)
        torch.cuda.synchronize()
        bad = [s for i, s in enumerate(ct.STREAMS)
               if not close(d[..., i], pd[..., i], 1e-4, 1e-5)[2]]
        if bad:
            raise AssertionError(f"K5 backward {name} disagrees with its "
                                 f"plain version: {bad}")
    key = f"k5 backward attrs {tuple(attrs.shape)}"
    results = {key: abba({name: (lambda k=k: bwd(k))
                          for name, k in builds.items()}, reps=10)}
    log(f"[builds] {key} ms: {results[key]}")
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_kernel_builds: CUDA is not available", file=sys.stderr)
        return 1
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    from ocrfdet_tpu_torch import kernels
    from ocrfdet_tpu_torch.ops import point_sample as ps
    from ocrfdet_tpu_torch.ops.splat import composite as ct

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    k4 = {"checkout": ps.KERNEL}
    k5 = {"checkout": ct.BWD_KERNEL}
    for tree in trees:
        for builds, base in ((k4, ps.KERNEL), (k5, ct.BWD_KERNEL)):
            k = build_of(base, tree)
            if k is not None:
                builds[tree] = k
    kernels.build([*k4.values(), *k5.values()])
    results = {}
    if len(k4) > 1:
        results.update(time_k4(dev, k4))
    if len(k5) > 1:
        results.update(time_k5(dev, k5))
    log(json.dumps({"device": smi, "builds": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
