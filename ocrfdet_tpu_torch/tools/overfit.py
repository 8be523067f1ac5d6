"""Overfit-to-convergence proof: train on a fixed fake-nuScenes set
(counterpart of tools_tpu/overfit.py).

Train the whole OcRFDet graph on a FIXED set of fake-nuScenes samples
(augmentation pinned to epoch 0, so the mapping image -> boxes is
deterministic) until the loss collapses, then run the complete decode
-> Scale-NMS -> native-mAP evaluation on the same samples from the raw
weights (the EMA ramps too slowly for a short run). If the assembled
system (losses, optimizer, schedule, decode, NMS, evaluator) optimizes
and localizes, mAP on the memorized set approaches 1; a wiring fault
(a sign, a dead gradient, a decode offset) keeps it near 0.

  python -m ocrfdet_tpu_torch.tools.overfit --samples 16 --epochs 400 \
      --lr 1e-3 --work-dir build/overfit [--device cuda]

Writes <work-dir>/overfit_result.json, prints one JSON summary line and
a PASS/FAIL line, and exits 1 on FAIL. Only the newest checkpoint is
kept (every 10 epochs; a killed run resumes from it).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


class FixedEpochDataset:
    """Pins the augmentation RNG to epoch 0 so every epoch sees the
    exact same (augmented) samples — the overfit target set."""

    def __init__(self, inner):
        self.inner = inner
        self.cfg = inner.cfg

    def __len__(self):
        return len(self.inner)

    def sample(self, i: int, epoch: int = 0):
        return self.inner.sample(i, epoch=0)


def heatmap_loss_of(rec: dict) -> float:
    return sum(v for k, v in rec.items()
               if k.endswith("loss_heatmap"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--work-dir", default="build/overfit")
    ap.add_argument("--flagship", action="store_true",
                    help="use the flagship config (slow) instead of tiny")
    ap.add_argument("--min-map", type=float, default=0.8)
    ap.add_argument("--bev", type=int, default=0,
                    help="override BEV grid size (e.g. 32 -> 32x32 at "
                         "3.2 m cells; tiny default is 16x16, whose "
                         "coarse cells cap localisation AP)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..config import ocrfdet_config, tiny_config
    from ..data.dataset import Loader, NuScenesDataset
    from ..data.fake_nuscenes import build_fake_nuscenes
    from ..train.evaluate import raw_detector, run_eval
    from ..train.trainer import Trainer

    base = ocrfdet_config() if args.flagship else tiny_config()
    if args.bev:
        n = args.bev
        cell = 102.4 / n
        base = dataclasses.replace(
            base,
            grid=dataclasses.replace(base.grid, x=(-51.2, 51.2, cell),
                                     y=(-51.2, 51.2, cell)),
            vt=dataclasses.replace(base.vt, bev_h=n, bev_w=n),
            # keep out_size_factor: voxel * 8 == BEV cell
            head=dataclasses.replace(base.head,
                                     voxel_size=(cell / 8, cell / 8)),
        )
    cfg = dataclasses.replace(
        base,
        batch_size=args.batch_size,
        optim=dataclasses.replace(
            base.optim, lr=args.lr, warmup_iters=args.warmup,
            max_epochs=args.epochs,
            # temporal fusion on from the start: the schedule gate is
            # tested elsewhere; here every step must exercise the full
            # graph that eval runs
            temporal_start_epoch=0),
    )

    os.makedirs(args.work_dir, exist_ok=True)
    data_root = os.path.join(args.work_dir, "fake_nuscenes")
    H, W = cfg.data.input_size
    pkl = build_fake_nuscenes(data_root, cfg, n_samples=args.samples,
                              img_hw=(2 * H, 2 * W), seed=0)

    ds = FixedEpochDataset(
        NuScenesDataset(cfg, pkl, is_train=True, cbgs=False))
    loader = Loader(ds, cfg.batch_size, shuffle=True, drop_last=True)
    eval_loader = Loader(ds, cfg.batch_size, shuffle=False,
                         drop_last=False)

    trainer = Trainer(cfg, args.work_dir, steps_per_epoch=len(loader),
                      device=args.device)
    trainer.init_state()
    start = trainer.resume()   # continue a killed run from its ckpt

    log_path = os.path.join(args.work_dir, "metrics.jsonl")
    if start == 0 and os.path.exists(log_path):
        os.remove(log_path)
    if start:
        print(f"resuming at epoch {start}", flush=True)
    saved = None
    for epoch in range(start, args.epochs):
        trainer.run_epoch(loader, epoch, log_every=max(len(loader), 1))
        if (epoch + 1) % 10 == 0 or epoch == args.epochs - 1:
            trainer.save(epoch)
            if saved is not None:
                os.remove(saved)
            saved = os.path.join(trainer.work_dir,
                                 f"ckpt_epoch_{epoch}.pt")

    # ---- loss curve summary from the metrics log
    with open(log_path) as f:
        recs = [json.loads(line) for line in f]
    first, last = recs[0], recs[-1]
    curve = dict(
        steps=args.epochs * len(loader),
        loss_total_first=first["loss_total"],
        loss_total_last=last["loss_total"],
        loss_heatmap_first=heatmap_loss_of(first),
        loss_heatmap_last=heatmap_loss_of(last),
    )

    # ---- full decode -> NMS -> native-metrics eval on the same set,
    # from the RAW weights (EMA ramps too slowly for a short overfit)
    metrics = run_eval(cfg, raw_detector(cfg, trainer.state), eval_loader)

    result = dict(curve, mAP=metrics["mAP"], NDS=metrics["NDS"],
                  mATE=metrics["mATE"], mASE=metrics["mASE"],
                  mAOE=metrics["mAOE"],
                  per_class_ap=metrics["per_class_ap"],
                  samples=args.samples,
                  config="flagship" if args.flagship else "tiny",
                  lr=args.lr, device=(torch.cuda.get_device_name(0)
                                      if trainer.device.type == "cuda"
                                      else "cpu"))
    with open(os.path.join(args.work_dir, "overfit_result.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))

    ok = (result["loss_total_last"] < 0.5 * result["loss_total_first"]
          and result["mAP"] >= args.min_map)
    print(f"overfit: {'PASS' if ok else 'FAIL'} "
          f"(loss {result['loss_total_first']:.2f} -> "
          f"{result['loss_total_last']:.2f}, mAP {result['mAP']:.3f})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
