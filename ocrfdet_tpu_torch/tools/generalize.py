"""Train/held-out generalization proof on rendered fake-nuScenes
(counterpart of tools_tpu/generalize.py).

  * data: rendered temporally-coherent scenes (data/fake_scene.py),
    whose images depict the boxes, built as DISJOINT train and held-out
    sets (different seeds, so different object layouts);
  * training: the standard Trainer with live augmentation (random
    resize/crop/flip/rotate + BDA), CBGS resampling and the epoch gates
    of the real recipe;
  * eval (raw weights): decode -> Scale-NMS -> native mAP/NDS on (a) a
    train subset, (b) the held-out set, (c) the held-out set with
    temporal fusion off (with_prev=0), the ablation that shows whether
    the temporal path pulls weight;
  * throughput: steady-state frames/s from metrics.jsonl.

Writes <work-dir>/generalize_result.json and prints one JSON line;
resumable (a checkpoint every 5 epochs + latest.json). Runs on the card
unless `--device cpu` is given.

  python -m ocrfdet_tpu_torch.tools.generalize --train-samples 144 \
      --epochs 60 --work-dir build/generalize
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train-samples", type=int, default=144)
    ap.add_argument("--held-samples", type=int, default=32)
    ap.add_argument("--scene-len", type=int, default=8)
    ap.add_argument("--objects", type=int, default=20)
    ap.add_argument("--img-hw", type=int, nargs=2, default=(450, 800))
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--max-steps-per-epoch", type=int, default=80,
                    help="cap CBGS-inflated epochs (the class-balanced "
                         "index list can be several x the distinct "
                         "sample count)")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--work-dir", default="build/generalize")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config smoke mode")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..config import ocrfdet_config, tiny_config
    from ..data.dataset import Loader, NuScenesDataset
    from ..data.fake_nuscenes import build_fake_nuscenes
    from ..train.evaluate import raw_detector, run_eval
    from ..train.trainer import Trainer

    base = tiny_config() if args.tiny else ocrfdet_config()
    cfg = dataclasses.replace(
        base, batch_size=args.batch_size,
        optim=dataclasses.replace(
            base.optim, lr=args.lr, warmup_iters=args.warmup,
            max_epochs=args.epochs))

    os.makedirs(args.work_dir, exist_ok=True)
    img_hw = tuple(args.img_hw)
    roots = {}
    for split, n, seed in (("train", args.train_samples, 0),
                           ("held", args.held_samples, 7777)):
        root = os.path.join(args.work_dir, f"scenes_{split}")
        pkl = os.path.join(root, "infos.pkl")
        if not os.path.exists(pkl):
            print(f"rendering {split} set ({n} samples)...", flush=True)
            build_fake_nuscenes(root, cfg, n_samples=n, img_hw=img_hw,
                                seed=seed, scene=True,
                                scene_len=args.scene_len,
                                n_objects=args.objects)
        roots[split] = pkl

    train_ds = NuScenesDataset(cfg, roots["train"], is_train=True,
                               cbgs=True)
    loader = Loader(train_ds, cfg.batch_size, shuffle=True,
                    num_workers=8, prefetch=4)
    print(f"train: {len(train_ds)} CBGS-resampled samples "
          f"({args.train_samples} distinct), "
          f"{len(loader)} steps/epoch", flush=True)

    trainer = Trainer(cfg, args.work_dir, steps_per_epoch=len(loader),
                      device=args.device)
    trainer.init_state()
    start = trainer.resume()
    if start:
        print(f"resuming at epoch {start}", flush=True)
    log_path = os.path.join(args.work_dir, "metrics.jsonl")
    if not args.eval_only:
        if start == 0 and os.path.exists(log_path):
            os.remove(log_path)
        for epoch in range(start, args.epochs):
            trainer.run_epoch(loader, epoch, log_every=20,
                              max_steps=args.max_steps_per_epoch)
            if (epoch + 1) % 5 == 0 or epoch == args.epochs - 1:
                trainer.save(epoch)

    # ---- loss curve + steady-state throughput from the log
    recs = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            recs = [json.loads(line) for line in f]
    curve = {}
    if recs:
        tail_fps = [r["frames_per_s"] for r in recs
                    if r.get("iter", 0) >= 40]
        curve = dict(
            loss_total_first=recs[0]["loss_total"],
            loss_total_last=recs[-1]["loss_total"],
            steady_frames_per_s=(round(float(np.median(tail_fps)), 3)
                                 if tail_fps else None))

    # ---- eval: train subset / held-out / held-out without temporal
    model = raw_detector(cfg, trainer.state)
    evals = {}
    for name, (split, wp) in (
            ("train_subset", ("train", 1.0)),
            ("held_out", ("held", 1.0)),
            ("held_out_no_prev", ("held", 0.0))):
        ds = NuScenesDataset(cfg, roots[split], is_train=False, cbgs=False)
        if name == "train_subset":
            ds.indices = ds.indices[:args.held_samples]
        ev_loader = Loader(ds, cfg.batch_size, shuffle=False,
                           drop_last=False, num_workers=8)
        m = run_eval(cfg, model, ev_loader, with_prev=wp)
        evals[name] = dict(mAP=m["mAP"], NDS=m["NDS"], mATE=m["mATE"],
                           mAVE=m.get("mAVE"),
                           per_class_ap=m["per_class_ap"])
        print(f"[eval {name}] mAP {m['mAP']:.3f} NDS {m['NDS']:.3f}",
              flush=True)

    result = dict(
        config="tiny" if args.tiny else "flagship",
        train_samples=args.train_samples,
        held_samples=args.held_samples,
        cbgs_len=len(train_ds), epochs=args.epochs, lr=args.lr,
        live_aug=True, img_hw=list(img_hw), **curve, evals=evals,
        temporal_gain_held_mAP=round(
            evals["held_out"]["mAP"]
            - evals["held_out_no_prev"]["mAP"], 4))
    with open(os.path.join(args.work_dir, "generalize_result.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
