#!/usr/bin/env python3
"""Time the PyTorch port's K3 backward, K4 forward and K5 forward and
backward from other source trees against this checkout's, on one NVIDIA
GPU, each through its own tree's wrapper.

    python3 bench_kernel_builds.py TREE [TREE ...]

Each TREE is a directory holding a whole `ocrfdet_tpu_torch/` package:
a checkout of another commit (`git archive <commit> ocrfdet_tpu_torch |
tar -x -C build/parent`) or a copy with an edited source. Its wrapper
modules are imported from there beside the checkout's, so each tree
launches its kernels as its own wrappers do (whatever their entry
points take, and with what the wrapper launches around the kernel) and
builds them from its own sources into its own `build/`. Every tree's
wrapper is first held to the plain version (K3 at rtol 1e-5, atol 1e-5
x each gradient's scale, as chip_smoke.check_k3_bwd; K4 bit for bit; K5
per output or stream at rtol 1e-4, atol 1e-5 x its scale, the forward's
median and crossing slot flipping on at most 1 pixel in 10^4 and its
bits the same on two runs, as chip_smoke.check_k5), then timed A B B A:
in the order checkout, trees, then in reverse, the mean of the two
readings, each `chip_smoke.device_ms` (device time per call from
torch.profiler):
- K3's backward at the training step's shape (batch 2, as
  chip_smoke.check_k3_bwd), `ht_pool_points_backward`;
- K4's forward at batch 2 with C = 4, on 16-byte aligned maps and on
  maps 4 bytes past that alignment (the launcher sends those to the
  scalar form), and at batch 1 with C = 1, beside `F.grid_sample`;
- K5's forward and backward on the streams of one flagship training
  step at batch 2 (recorded as chip_smoke records them), with random
  cotangents.
Prints the card's name and power limit, then one JSON line of the
readings.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from chip_smoke import close, device_ms, log

PKG = "ocrfdet_tpu_torch"
WRAPPERS = {"k3": "ops.ht_pool", "k4": "ops.point_sample",
            "k5": "ops.splat.composite"}


def abba(cases: dict, reps: int) -> dict:
    """Device ms of each of `cases` (name: fn), timed in the order of the
    dict and then in reverse, the mean of the two."""
    names = list(cases)
    t = {n: [] for n in names}
    for n in names + names[::-1]:
        t[n].append(device_ms(cases[n], reps))
    return {n: float(np.mean(v)) for n, v in t.items()}


def _ours(modules) -> dict:
    return {k: m for k, m in modules.items()
            if k == PKG or k.startswith(PKG + ".")}


def wrappers() -> dict:
    """The wrapper modules {"k3"|"k4"|"k5": module} that `import PKG`
    finds, with every kernel of them built (in parallel)."""
    kernels = importlib.import_module(f"{PKG}.kernels")
    mods = {k: importlib.import_module(f"{PKG}.{m}")
            for k, m in WRAPPERS.items()}
    kernels.build([v for m in mods.values() for v in vars(m).values()
                   if isinstance(v, kernels.Kernel)])
    return mods


def load_tree(tree: str) -> dict:
    """`wrappers()` imported from TREE's `ocrfdet_tpu_torch/` (their
    relative imports bind TREE's own modules, and its kernels build from
    its sources into its `build/`); the checkout's modules are back in
    sys.modules after."""
    root = Path(tree).resolve()
    if not (root / PKG / "__init__.py").exists():
        raise SystemExit(f"bench_kernel_builds: {root} holds no {PKG}/")
    saved = _ours(sys.modules)
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    try:
        return wrappers()
    finally:
        sys.path.remove(str(root))
        for k in _ours(sys.modules):
            del sys.modules[k]
        sys.modules.update(saved)


def time_k3(dev, trees: dict) -> dict:
    """K3's backward through each tree's `ht_pool_points_backward`."""
    from ocrfdet_tpu_torch.config import ocrfdet_config
    from ocrfdet_tpu_torch.ops import ht_pool as htp

    args, cot = chip_smoke.k3_bwd_inputs(ocrfdet_config(batch_size=1), dev)
    (pdep, pctx), _ = chip_smoke.plain_grads(htp.ht_pool_points_plain, args,
                                             (0, 1), cot)
    cases = {name: (lambda m=m: m["k3"].ht_pool_points_backward(*args, cot))
             for name, m in trees.items()}
    for name, fn in cases.items():
        got = fn()
        torch.cuda.synchronize()
        if not all(close(g, w, 1e-5, 1e-5)[2]
                   for g, w in zip(got, (pdep, pctx))):
            raise AssertionError(f"K3 backward {name} disagrees with its "
                                 f"plain version")
    key = f"k3 backward dout {tuple(cot.shape)}"
    results = {key: abba(cases, reps=20)}
    log(f"[builds] {key} ms: {results[key]}")
    return results


def time_k4(dev, trees: dict) -> dict:
    """K4's forward through each tree's `point_sample_points`."""
    import torch.nn.functional as F
    from ocrfdet_tpu_torch.config import ocrfdet_config
    from ocrfdet_tpu_torch.ops import point_sample as ps

    results = {}
    cfg = ocrfdet_config(batch_size=1)
    for B, C in ((2, 4), (1, 1)):
        maps, px, py = chip_smoke.k4_inputs(cfg, dev, B, C)
        H, W = maps.shape[1:3]
        shifted = torch.empty(maps.numel() + 1, device=dev)[1:].view(
            maps.shape)
        shifted.copy_(maps)
        want = ps.point_sample_points_plain(maps, px, py)

        def run(m, x):
            return lambda: m["k4"].point_sample_points(x, px, py)
        cases = {}
        for name, m in trees.items():
            cases[name] = run(m, maps)
            if C == 4:
                cases[f"{name}, maps 4 bytes off"] = run(m, shifted)
        for name, fn in cases.items():
            out = fn()
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


def time_k5(dev, trees: dict) -> dict:
    """K5's forward and backward through each tree's `composite_forward`
    and `composite_backward`."""
    from ocrfdet_tpu_torch import entry
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
    prgb, pmed, plogt, pcross = ct.composite_forward_plain(attrs, T, n_tx,
                                                           16, 16)
    gen = torch.Generator(device=dev).manual_seed(15)
    g_rgb = torch.randn(prgb.shape, generator=gen, device=dev)
    g_med = torch.randn(prgb.shape[:2], generator=gen, device=dev)
    g_logt = torch.randn(prgb.shape[:2], generator=gen, device=dev)
    bwd_args = (attrs, prgb, g_rgb, g_logt, g_med, pcross, T, n_tx, 16)
    pd = ct.composite_backward_plain(*bwd_args[:-1], 16, 16)
    results = {}
    bwd = {name: (lambda m=m: m["k5"].composite_backward(*bwd_args))
           for name, m in trees.items()}
    for name, fn in bwd.items():
        d = fn()
        torch.cuda.synchronize()
        bad = [s for i, s in enumerate(ct.STREAMS)
               if not close(d[..., i], pd[..., i], 1e-4, 1e-5)[2]]
        if bad:
            raise AssertionError(f"K5 backward {name} disagrees with its "
                                 f"plain version: {bad}")
    key = f"k5 backward attrs {tuple(attrs.shape)}"
    results[key] = abba(bwd, reps=10)
    log(f"[builds] {key} ms: {results[key]}")
    fwd = {name: (lambda m=m: m["k5"].composite_forward(attrs, T, n_tx, 16))
           for name, m in trees.items()}
    for name, fn in fwd.items():
        rgb, med, logt, cross = got = fn()
        again = fn()
        torch.cuda.synchronize()
        flips = max(int((med - pmed).abs().gt(1e-5 * pmed.abs()).sum()),
                    int((cross != pcross).sum()))
        if not (close(rgb, prgb, 1e-4, 1e-5)[2]
                and close(logt, plogt, 1e-4, 1e-5)[2]
                and flips <= med.numel() // 10000
                and all(map(torch.equal, got, again))):
            raise AssertionError(f"K5 forward {name} disagrees with its "
                                 f"plain version or with itself")
    key = f"k5 forward attrs {tuple(attrs.shape)}"
    results[key] = abba(fwd, reps=20)
    log(f"[builds] {key} ms: {results[key]}")
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_kernel_builds: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    trees = {"checkout": wrappers()}
    trees.update((tree, load_tree(tree)) for tree in sys.argv[1:])
    results = {}
    for time in (time_k3, time_k4, time_k5):
        results.update(time(dev, trees))
    log(json.dumps({"device": smi, "builds": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
