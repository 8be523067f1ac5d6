"""Parameters and the forward's floating-point operations (counterpart
of tools_tpu/get_flops.py, the reference's tools/analysis_tools/
get_flops.py).

  python -m ocrfdet_tpu_torch.tools.get_flops [--tiny] [--train] \\
      [--batch-size 1] [--device cuda]

Builds `ocrfdet_config` (`--tiny`: `tiny_config`) with seeded random
weights: the eval model, or with `--train` the training model (render
heads) in train mode, whose forward adds the render branch, as JAX's
`--train` counts its training forward. It runs one forward on a
synthetic batch and counts:
  * the parameters (every element, as JAX counts its init tree);
  * the matrix products and convolutions of the forward, by
    `torch.utils.flop_counter.FlopCounterMode` (2 per multiply-add);
  * apart, the hand-written kernels K1-K5, which that mode does not see
    (ctypes launches on the card; on the CPU their plain versions, which
    hold no matrix product or convolution): each call's operations and
    bytes from `ops/work.py`, the counts their bounds in chip_smoke.py
    use, worked out from the call's inputs.
Prints one JSON line. Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import json
from typing import Dict, List
from unittest import mock


@contextlib.contextmanager
def recording_kernels():
    """Route the model's K1-K5 wrappers through recorders: yields
    {row name: [(inputs, output)]}, one entry per call."""
    from ..ops import bev_pool as bp
    from ..ops import cost_volume as cvm
    from ..ops import ht_pool as htp
    from ..ops import point_sample as ps
    from ..ops.splat import composite as ct
    entries = {"K1 cost_volume": (cvm, "cost_volume"),
               "K2 bev_pool": (bp, "lss_pool"),
               "K3 ht_pool": (htp, "ht_pool_points"),
               "K4 point_sample": (ps, "point_sample_points"),
               "K5 composite_tiles": (ct, "composite_tiles")}
    calls: Dict[str, List] = {name: [] for name in entries}
    with contextlib.ExitStack() as stack:
        for name, (mod, attr) in entries.items():
            def rec(*args, _f=getattr(mod, attr), _calls=calls[name]):
                out = _f(*args)
                _calls.append((args, out))
                return out
            stack.enter_context(mock.patch.object(mod, attr, rec))
        yield calls


def kernel_work(calls: Dict[str, List]) -> Dict[str, Dict]:
    """{row: {calls, flops, bytes}} of `recording_kernels`' calls."""
    from ..ops import bev_pool as bp
    from ..ops import work

    def one(name, args, out):
        if name.startswith("K1"):
            return work.cost_volume_work(*args[:7], out)
        if name.startswith("K2"):
            w, pix, cell, feat, cells = bp.lss_points(*args)
            return work.bev_pool_work(w, pix, cell, feat, out, cells)
        if name.startswith("K3"):
            return work.ht_pool_work(*args, out)
        if name.startswith("K4"):
            return work.point_sample_work(*args, out)
        attrs, n_tiles, n_tx = args[:3]
        return work.composite_forward_work(
            attrs, *out, work.composite_work(attrs, n_tiles, n_tx))
    rows = {}
    for name, cs in calls.items():
        ws = [one(name, a, o) for a, o in cs]
        rows[name] = dict(calls=len(ws),
                          flops=sum(w["flops"] for w in ws),
                          bytes=sum(w["bytes"] for w in ws))
    return rows


def count(cfg, train: bool, batch_size: int, device) -> Dict:
    """Parameters, FlopCounterMode's forward FLOPs and the kernels'
    rows of one forward of `cfg`'s model on `device`."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .. import entry
    from ..models.detector import OcRFDet
    from ..utils.weights import init_weights

    model = init_weights(OcRFDet(cfg, render_heads=train), seed=0)
    model = model.to(device).train(train)
    n_params = sum(p.numel() for p in model.parameters())
    batch = entry.make_batch(cfg, seed=0, batch_size=batch_size,
                             device=device, with_targets=train)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), recording_kernels() as calls, counter:
        model(batch)
    rows = kernel_work(calls)
    torch_flops = counter.get_total_flops()
    kernel_flops = sum(r["flops"] for r in rows.values())
    return dict(params=n_params, torch_flops=torch_flops,
                kernels=rows, kernel_flops=kernel_flops,
                total_flops=torch_flops + kernel_flops)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--train", action="store_true",
                    help="the training forward (render branch included)")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..config import ocrfdet_config, tiny_config
    from ..entry import resolve_device

    device = resolve_device(args.device)
    cfg = (tiny_config if args.tiny else ocrfdet_config)(
        batch_size=args.batch_size)
    result = dict(config="tiny_config" if args.tiny else "ocrfdet_config",
                  train=args.train, batch_size=args.batch_size,
                  **count(cfg, args.train, args.batch_size, device))
    result["device"] = (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
