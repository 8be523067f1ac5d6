"""Dataset + threaded loader (a copy of ocrfdet_tpu/data/dataset.py).

Replaces mmdet's build_dataloader (apis/train.py:208-220): a
NuScenesDataset over info files with optional CBGS resampling, a
thread-pool prefetching loader (the pipeline is numpy/PIL-bound, which
releases the GIL for image decode), and seeded per-sample RNG for
deterministic augmentation. The loader's threads run only numpy and
PIL: the batches reach the card on the consumer's thread
(`train/trainer.py::device_batch`).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from ..config import OcRFDetConfig
from . import infos as INF
from .pipeline import collate, multi_scale_flip_aug, prepare_sample


class NuScenesDataset:
    def __init__(self, cfg: OcRFDetConfig, info_path: str,
                 is_train: bool = True, cbgs: bool = True):
        self.cfg = cfg
        self.is_train = is_train
        self.infos = INF.load_infos(info_path)
        if is_train and cbgs:
            self.indices = INF.cbgs_indices(
                self.infos, num_classes=len(cfg.class_names),
                seed=cfg.seed)
        else:
            self.indices = np.arange(len(self.infos))

    def __len__(self):
        return len(self.indices)

    def sample(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + epoch * 997 + int(i)) % (2 ** 63))
        s = prepare_sample(self.cfg, self.infos, int(self.indices[i]),
                           rng, is_train=self.is_train)
        if not self.is_train:
            # eval samples pass through the identity TTA wrapper
            # (reference MultiScaleFlipAug3D; see pipeline.py)
            (s,) = multi_scale_flip_aug(s)
        return s


class Loader:
    """Shuffling, batching, thread-prefetching iterator."""

    def __init__(self, dataset: NuScenesDataset, batch_size: int,
                 shuffle: bool = True, num_workers: int = 8,
                 drop_last: bool = True, prefetch: int = 4,
                 process_index: int = 0, process_count: int = 1):
        """`batch_size` is the GLOBAL batch; in a multi-process run
        each process loads only its batch_size // process_count slice
        of every batch (the DistributedSampler analog,
        apis/train.py:208-220), and all processes draw the identical
        shuffled order from the shared seed."""
        if batch_size % max(process_count, 1):
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"process_count {process_count}")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = max(process_count, 1)
        self.local_batch_size = batch_size // self.process_count

    def __len__(self):
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.ds.cfg.seed + epoch).shuffle(order)
        n_batches = len(self)
        lo = self.process_index * self.local_batch_size
        hi = lo + self.local_batch_size
        full = [order[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(n_batches)]
        if full and len(full[-1]) < self.batch_size:
            # drop_last=False: pad the ragged tail batch by cycling its
            # own samples so every process still receives an equal
            # slice (make_array_from_process_local_data needs equal
            # shards). The duplicates carry repeated sample_tokens and
            # are deduplicated by the evaluator — the reference's
            # multi_gpu_test evaluates every val sample exactly once.
            full[-1] = np.resize(full[-1], self.batch_size)
        batches = [b[lo:hi] for b in full]

        # Per-SAMPLE fan-out over a real thread pool (PIL decode +
        # numpy aug release the GIL), with `prefetch` whole batches in
        # flight ahead of the consumer — the analog of the reference's
        # workers_per_gpu=8 loader (apis/train.py:208-220). A dedicated
        # scheduler thread keeps submitting while the consumer is
        # inside the train step.
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=max(1, self.num_workers))

        def put(item) -> bool:
            # q.put blocks once `prefetch` batches are pending, bounding
            # the futures in flight to prefetch * batch_size samples; it
            # gives up once the consumer has stopped.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def scheduler():
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    if not put([pool.submit(self.ds.sample, int(i), epoch)
                                for i in idxs]):
                        return
            finally:
                put(None)

        t = threading.Thread(target=scheduler, daemon=True)
        t.start()
        try:
            while True:
                futs = q.get()
                if futs is None:
                    break
                yield collate([f.result() for f in futs])
        finally:
            # a consumer that stops early (or fails) ends the scheduler
            # and drops the samples not yet started
            stop.set()
            t.join()
            pool.shutdown(wait=False, cancel_futures=True)
