"""Lightweight multi-threaded data loader (replaces torch DataLoader +
DistributedSampler): a copy of xmem2_tpu/train/loader.py.

- Shuffled epoch ordering from a seeded Generator (set_epoch for determinism)
- rank/world_size sharding (every rank sees a disjoint slice per epoch —
  the DistributedSampler contract, reference train.py:120)
- Background worker threads decode/augment ahead of the training step; a
  dataset error reaches the consumer, and a consumer that leaves the loop
  early stops the workers (the JAX package's loader waits forever on the
  first and leaves the workers blocked on the second)
"""

import queue
import threading
from typing import Iterator, Optional

import numpy as np


def _stack(batch):
    out = {}
    for k in batch[0]:
        if k == 'info':
            out[k] = [b[k] for b in batch]
        else:
            out[k] = np.stack([b[k] for b in batch], 0)
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, rank: int = 0, world_size: int = 1,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        # pad so every rank gets the same count (DistributedSampler behavior)
        per_rank = -(-n // self.world_size)
        padded = np.concatenate([order, order[:per_rank * self.world_size - n]])
        return padded[self.rank::self.world_size]

    def __len__(self):
        per_rank = -(-len(self.dataset) // self.world_size)
        if self.drop_last:
            return per_rank // self.batch_size
        return -(-per_rank // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        """Batches in order. A dataset error is raised here, in the
        consumer; leaving the loop early stops the workers."""
        indices = self._indices()
        nb = len(self)
        out_q: 'queue.Queue' = queue.Queue(maxsize=self.num_workers * 2)
        job_q: 'queue.Queue' = queue.Queue()
        for bi in range(nb):
            job_q.put((bi, indices[bi * self.batch_size:
                                   (bi + 1) * self.batch_size]))
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    bi, idxs = job_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = _stack([self.dataset[int(i)] for i in idxs])
                except Exception as e:   # handed to the consumer
                    batch = e
                while not stop.is_set():
                    try:
                        out_q.put((bi, batch), timeout=0.1)
                        break
                    except queue.Full:
                        pass

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        results = {}
        try:
            for next_bi in range(nb):
                while next_bi not in results:
                    bi, batch = out_q.get()
                    results[bi] = batch
                batch = results.pop(next_bi)
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
