"""Evaluate OcRFDet's EMA weights on a val info file (counterpart of
tools_tpu/eval.py).

  python -m ocrfdet_tpu_torch.tools.eval \
      --infos data/bevdetv2-nuscenes_infos_val.pkl \
      --ckpt work/ocrfdet/ckpt_epoch_19.pt [--out results.json]
  torchrun --nproc-per-node N -m ocrfdet_tpu_torch.tools.eval \
      --multihost --infos ... --ckpt ...

Loads a checkpoint written by `tools.train` (`Trainer.save`), builds
the eval model from its EMA parameters and BatchNorm statistics, runs
forward and decode on the card and Scale-NMS on the host over every
sample once, and prints the metrics dict (mAP, NDS, the TP errors) as
JSON; `--out` also writes the devkit-format results. Runs on the card
unless `--device cpu` is given. With `--multihost` (one process per
card, from `torchrun`'s environment) each of min(N / space, batch
size) data ranks evaluates its rows of every batch and the results are
merged (the multi-GPU-test analog; JAX's tools_tpu/eval.py shards over
its `data` axis the same way); a config with `parallel.space_axis` > 1
splits each data rank's work over that many ranks, and rank 0 reports.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--infos", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-batches", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--multihost", action="store_true",
                    help="shard eval over torchrun's processes, one a card")
    args = ap.parse_args(argv)

    import torch

    from .. import entry
    from ..config import ocrfdet_config, tiny_config
    from ..data.dataset import Loader, NuScenesDataset
    from ..train.evaluate import ema_detector, run_eval

    cfg = tiny_config() if args.tiny else ocrfdet_config()
    mesh = None
    if args.multihost:
        from ..parallel.mesh import init_data_mesh, release
        mesh = init_data_mesh(args.batch_size, device=args.device,
                              space=cfg.parallel.space_axis)
        if not mesh.active:
            print(f"rank {mesh.rank}: idle (the data axis has {mesh.data} "
                  f"ranks for batch {args.batch_size})")
            release()
            return None
        device = mesh.device
    else:
        device = entry.resolve_device(args.device)
    dataset = NuScenesDataset(cfg, args.infos, is_train=False, cbgs=False)
    loader = Loader(dataset, args.batch_size, shuffle=False,
                    drop_last=False,
                    process_index=mesh.d if mesh else 0,
                    process_count=mesh.data if mesh else 1)
    model = ema_detector(cfg, torch.load(args.ckpt, map_location=device),
                         device)
    token_to_pose = {
        info["token"]: dict(
            ego2global_rotation=info["cams"]["CAM_FRONT"]
            ["ego2global_rotation"],
            ego2global_translation=info["cams"]["CAM_FRONT"]
            ["ego2global_translation"])
        for info in dataset.infos}
    metrics = run_eval(cfg, model, loader, out_json=args.out,
                       max_batches=args.max_batches or None,
                       token_to_pose=token_to_pose, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        print(json.dumps(metrics, indent=2, default=float))
    if mesh is not None:
        release()
    return metrics


if __name__ == "__main__":
    main()
