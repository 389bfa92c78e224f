"""The training loader: torch.utils.data.DataLoader with worker processes,
as the reference trains (reference train.py:121).

- EpochSampler yields the JAX loader's order (xmem2_tpu/train/loader.py):
  a shuffle seeded by seed + epoch (set_epoch), padded so every rank gets
  the same count and strided by rank, the DistributedSampler contract
  (reference train.py:120);
- worker processes decode and augment ahead of the training step and
  collate each batch into tensors, pinned when CUDA is present so do_pass
  copies them without blocking;
- each worker reseeds the datasets' generators from (seed, epoch, rank,
  worker id), as the reference's worker_init_fn reseeds numpy: a forked
  worker would otherwise repeat every other worker's augmentations, since
  the datasets draw from one generator each;
- the workers are forked. Forking after CUDA is initialised (NCCL under
  torchrun) is safe because a worker never touches CUDA: the datasets are
  numpy and PIL, collation makes host tensors, and pinning happens in the
  main process;
- a dataset error is raised in the consumer; leaving the loop early stops
  the workers.

With num_workers=0 the main process reads the datasets with their own
generators.
"""

from functools import partial
from typing import Iterator

import numpy as np
import torch


def _stack(batch):
    out = {}
    for k in batch[0]:
        if k == 'info':
            out[k] = [b[k] for b in batch]
        else:
            out[k] = torch.from_numpy(np.stack([b[k] for b in batch], 0))
    return out


class EpochSampler(torch.utils.data.Sampler):
    def __init__(self, n: int, shuffle: bool, rank: int, world_size: int,
                 seed: int):
        self.n, self.shuffle = n, shuffle
        self.rank, self.world_size, self.seed = rank, world_size, seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        """This rank's sample indices for the epoch."""
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        # pad so every rank gets the same count (DistributedSampler behavior)
        per_rank = len(self)
        padded = np.concatenate(
            [order, order[:per_rank * self.world_size - self.n]])
        return padded[self.rank::self.world_size]

    def __iter__(self):
        return (int(i) for i in self.indices())

    def __len__(self):
        return -(-self.n // self.world_size)


def reseed(dataset, seed: int, epoch: int, rank: int, worker_id: int):
    """Fresh generators for `dataset` and the datasets it concatenates
    (`.datasets`), drawn from (seed, epoch, rank, worker_id) and each
    dataset's place among them: what a worker process runs first."""
    seen = []

    def visit(ds):
        if any(ds is s for s in seen):
            return
        seen.append(ds)
        if hasattr(ds, 'rng'):
            ds.rng = np.random.default_rng(
                [seed, epoch, rank, worker_id, len(seen) - 1])
        for child in getattr(ds, 'datasets', ()):
            visit(child)

    visit(dataset)


def _init_worker(worker_id: int, seed: int, epoch: int, rank: int):
    reseed(torch.utils.data.get_worker_info().dataset, seed, epoch, rank,
           worker_id)


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, rank: int = 0, world_size: int = 1,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.rank = rank
        self.seed = seed
        self.drop_last = drop_last
        self.sampler = EpochSampler(len(dataset), shuffle, rank, world_size,
                                    seed)

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def _indices(self):
        return self.sampler.indices()

    def __len__(self):
        per_rank = len(self.sampler)
        if self.drop_last:
            return per_rank // self.batch_size
        return -(-per_rank // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        """Batches in order. A dataset error is raised here, in the
        consumer; leaving the loop early stops the workers."""
        workers = self.num_workers > 0
        loader = torch.utils.data.DataLoader(
            self.dataset, batch_size=self.batch_size, sampler=self.sampler,
            num_workers=self.num_workers, collate_fn=_stack,
            pin_memory=torch.cuda.is_available(), drop_last=self.drop_last,
            worker_init_fn=partial(_init_worker, seed=self.seed,
                                   epoch=self.sampler.epoch,
                                   rank=self.rank) if workers else None,
            multiprocessing_context='fork' if workers else None)
        batches = iter(loader)
        try:
            yield from batches
        finally:
            shutdown = getattr(batches, '_shutdown_workers', None)
            if shutdown is not None:
                shutdown()
