"""Train OcRFDet (counterpart of tools_tpu/train.py).

  python -m ocrfdet_tpu_torch.tools.train \
      --infos data/bevdetv2-nuscenes_infos_train.pkl \
      --work-dir work/ocrfdet [--tiny | --geoenh [--vggt-ckpt PATH] |
      --frames8] [--resume] [--device cuda]
  torchrun --nproc-per-node N -m ocrfdet_tpu_torch.tools.train \
      --multihost --infos ... --work-dir ...

With `--multihost` (one process per card, from `torchrun`'s
environment) the run is data-parallel over min(N / space, batch size)
data ranks (`parallel/`): each loads its slice of every global batch,
and with a config's `parallel.space_axis` > 1 that many ranks split its
cameras, BEV rows and render bands; the gradients are averaged, the
optimizer state and the EMAs are ZeRO slices, and rank 0 writes the
whole state; a rank past data x space stays idle.

`--geoenh` trains GeoEnhDet (`geoenh_config()`, batch 4) with its frozen
VGGT-1B teacher, whose weights are seeded random unless `--vggt-ckpt`
names the released checkpoint; `--frames8` the 8-frame variant.
Reads the info file and its images through the augmenting pipeline
(CBGS resampling, 8 loader threads), trains `optim.max_epochs` epochs
with the reference's epoch gates, and writes a checkpoint and
`latest.json` after every epoch and `metrics.jsonl` as it goes. Runs on
the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses


def select_config(args):
    """The config the options name, with the JAX tool's precedence:
    --tiny, then --geoenh (with --vggt-ckpt), then --frames8, else the
    flagship; then --no-ocrf and --batch-size."""
    from ..config import (geoenh_config, ocrfdet_8f_config, ocrfdet_config,
                          tiny_config)
    if args.tiny:
        cfg = tiny_config()
    elif args.geoenh:
        cfg = geoenh_config()
        if args.vggt_ckpt:
            cfg = dataclasses.replace(cfg, vggt_teacher=dataclasses.replace(
                cfg.vggt_teacher, ckpt_path=args.vggt_ckpt))
    elif args.frames8:
        cfg = ocrfdet_8f_config()
    else:
        cfg = ocrfdet_config()
    if args.no_ocrf:
        cfg = dataclasses.replace(cfg, with_ocrf=False)
    if args.batch_size:
        cfg = dataclasses.replace(cfg, batch_size=args.batch_size)
    return cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--infos", required=True)
    ap.add_argument("--work-dir", default="work/ocrfdet")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (debug)")
    ap.add_argument("--no-ocrf", action="store_true")
    ap.add_argument("--geoenh", action="store_true",
                    help="GeoEnhDet (VGGT distillation) flagship config")
    ap.add_argument("--vggt-ckpt", default="",
                    help="path to the released VGGT-1B torch checkpoint")
    ap.add_argument("--frames8", action="store_true",
                    help="8-frame test-set variant")
    ap.add_argument("--batch-size", type=int, default=0)
    ap.add_argument("--max-steps-per-epoch", type=int, default=0)
    ap.add_argument("--multihost", action="store_true",
                    help="data-parallel over torchrun's processes, one a "
                         "card (NCCL; gloo with --device cpu)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from ..data.dataset import Loader, NuScenesDataset
    from ..train.trainer import Trainer

    cfg = select_config(args)
    mesh = None
    if args.multihost:
        from ..parallel.mesh import init_data_mesh, release
        mesh = init_data_mesh(cfg.batch_size, device=args.device,
                              space=cfg.parallel.space_axis)
        if not mesh.active:
            print(f"rank {mesh.rank}: idle (the data axis has {mesh.data} "
                  f"ranks for batch {cfg.batch_size})")
            release()
            return
    dataset = NuScenesDataset(cfg, args.infos, is_train=True)
    loader = Loader(dataset, cfg.batch_size,
                    process_index=mesh.d if mesh else 0,
                    process_count=mesh.data if mesh else 1)
    trainer = Trainer(cfg, args.work_dir, steps_per_epoch=len(loader),
                      device=args.device, mesh=mesh)
    trainer.init_state()
    start = trainer.resume() if args.resume else 0
    trainer.fit(loader, start_epoch=start,
                max_steps_per_epoch=args.max_steps_per_epoch or None)
    if mesh is not None:
        release()


if __name__ == "__main__":
    main()
