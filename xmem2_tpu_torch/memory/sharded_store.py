"""Memory stores split by slot range over several devices (memory_shards).

Counterpart of the JAX manager's stores under its `memory` mesh axis
(xmem2_tpu/memory/manager.py:_place_store :358-380). A store of capacity C
over D devices is D StoreBuffers of C / D slots, shard d holding the global
slots [d * C / D, (d + 1) * C / D) on devices[d]; each shard's `size` is its
own occupied count. The functions mirror memory/store.py and update the
shards in place:

  - an append or a replacement writes straight into the shard slices it
    covers (it may straddle two shards);
  - compaction (removal, eviction) plans on the first device from the small
    metadata (which slots survive) and each shard then gathers its new rows
    from the shards they come from;
  - growth re-lays the occupied rows over the larger shards.

No operation gathers a whole store on one device.
"""

from dataclasses import dataclass
from typing import List, Optional

import torch

from xmem2_tpu_torch.memory import store as ST
from xmem2_tpu_torch.memory.store import LIFE_EPS, StoreBuffers

FIELDS = ('key', 'shrinkage', 'selection', 'value', 'val_valid', 'use_count',
          'life_count')
SLOT_DIM = {'value': 1, 'val_valid': 1}      # others: the slot axis is 0


@dataclass
class ShardedStore:
    shards: List[StoreBuffers]
    size: int = 0

    @property
    def shard_capacity(self) -> int:
        return self.shards[0].capacity

    @property
    def capacity(self) -> int:
        return self.shard_capacity * len(self.shards)

    @property
    def num_objects(self) -> int:
        return self.shards[0].num_objects

    @property
    def num_groups(self) -> int:
        return self.shards[0].num_groups

    @property
    def devices(self) -> List[torch.device]:
        return [s.key.device for s in self.shards]


def _set_size(store: ShardedStore, size: int):
    c = store.shard_capacity
    store.size = size
    for d, s in enumerate(store.shards):
        s.size = min(max(size - d * c, 0), c)


def _pieces(store: ShardedStore, start: int, end: int):
    """(shard index, local start, local end, offset into [start, end)) of
    every shard slice the slot range covers."""
    c = store.shard_capacity
    for d in range(start // c, min(-(-end // c), len(store.shards))):
        lo, hi = max(start, d * c), min(end, (d + 1) * c)
        if lo < hi:
            yield d, lo - d * c, hi - d * c, lo - start


def empty_store(capacity: int, num_objects: int, num_groups: int,
                key_dim: int, value_dim: int, devices,
                value_dtype=torch.float32) -> ShardedStore:
    if capacity % len(devices):
        raise ValueError(f'capacity {capacity} does not divide '
                         f'{len(devices)} shards')
    c = capacity // len(devices)
    return ShardedStore([ST.empty_store(c, num_objects, num_groups, key_dim,
                                        value_dim, dev, value_dtype)
                         for dev in devices])


def _slot_slice(t: torch.Tensor, name: str, lo: int, hi: int):
    return t[:, lo:hi] if SLOT_DIM.get(name, 0) else t[lo:hi]


def append(store: ShardedStore, key, shrinkage, selection, value,
           group_present) -> ShardedStore:
    """ST.append over the shards the new slots fall in."""
    n = key.shape[0]
    if store.size + n > store.capacity:
        raise ValueError(f'append of {n} slots overflows capacity '
                         f'{store.capacity} at size {store.size}')
    if group_present.dim() == 1:
        group_present = group_present[:, None].expand(store.num_groups, n)
    for d, lo, hi, off in _pieces(store, store.size, store.size + n):
        dev, m = store.devices[d], hi - lo
        ST.append(store.shards[d], key[off:off + m].to(dev),
                  shrinkage[off:off + m].to(dev),
                  None if selection is None else
                  selection[off:off + m].to(dev),
                  value[:, off:off + m].to(dev),
                  group_present[:, off:off + m].to(dev))
    store.size += n
    return store


def replace_at(store: ShardedStore, start: int, key, shrinkage, selection,
               value) -> ShardedStore:
    """ST.replace_at over the shards the slots fall in."""
    for d, lo, hi, off in _pieces(store, start, start + key.shape[0]):
        dev, m = store.devices[d], hi - lo
        ST.replace_at(store.shards[d], lo, key[off:off + m].to(dev),
                      shrinkage[off:off + m].to(dev),
                      None if selection is None else
                      selection[off:off + m].to(dev),
                      value[:, off:off + m].to(dev))
    return store


def update_usage(store: ShardedStore, usages: List[torch.Tensor],
                 frames: int = 1) -> ShardedStore:
    """ST.update_usage per shard, usages[d] on shard d's device."""
    for s, u in zip(store.shards, usages):
        ST.update_usage(s, u, frames=frames)
    return store


def usage(store: ShardedStore) -> torch.Tensor:
    """use / life of every slot [capacity], on the first device."""
    dev = store.devices[0]
    return torch.cat([ST.usage(s).to(dev) for s in store.shards])


def take(store: ShardedStore, name: str, idx: torch.Tensor,
         device=None) -> torch.Tensor:
    """Field `name` at the global slots idx (any order), on `device` (the
    first device by default): each shard hands over its own rows."""
    device = store.devices[0] if device is None else device
    c = store.shard_capacity
    dim = SLOT_DIM.get(name, 0)
    ref = getattr(store.shards[0], name)
    shape = list(ref.shape)
    shape[dim] = idx.numel()
    out = torch.empty(shape, dtype=ref.dtype, device=device)
    owner = torch.div(idx, c, rounding_mode='floor')
    for d, s in enumerate(store.shards):
        at = torch.nonzero(owner == d).flatten()
        if at.numel() == 0:
            continue
        local = (idx[at] - d * c).to(s.key.device)
        rows = getattr(s, name).index_select(dim, local).to(device)
        out.index_copy_(dim, at.to(device), rows)
    return out


def prefix_pieces(store: ShardedStore, n: int):
    """(key, shrinkage, values, validity) views of the slots [0, n), one per
    shard that holds any of them, in slot order."""
    out = []
    for d, lo, hi, _ in _pieces(store, 0, n):
        s = store.shards[d]
        out.append((s.key[lo:hi], s.shrinkage[lo:hi], s.value[:, lo:hi],
                    s.val_valid[:, lo:hi]))
    return out


def _compact(store: ShardedStore, keep: torch.Tensor) -> ShardedStore:
    """ST._compact across shards: the kept slots (keep [size] bool) move to
    the front in their order. Rows only move towards the front, so shard d
    gathers its new rows from shards >= d, which are rewritten after it."""
    idx = torch.nonzero(keep).flatten()
    m = idx.numel()
    c = store.shard_capacity
    for d, s in enumerate(store.shards):
        lo, hi = min(d * c, m), min((d + 1) * c, m)
        n = hi - lo
        if n:
            src = idx[lo:hi]
            rows = {name: take(store, name, src, s.key.device)
                    for name in FIELDS}
            for name, r in rows.items():
                _slot_slice(getattr(s, name), name, 0, n).copy_(r)
        s.val_valid[:, n:] = False
        s.use_count[n:] = 0.0
        s.life_count[n:] = LIFE_EPS
    _set_size(store, m)
    return store


def remove_range(store: ShardedStore, start: int, end: int) -> ShardedStore:
    idx = torch.arange(store.size, device=store.devices[0])
    return _compact(store, (idx < start) | (idx >= end))


def eviction_keep(store: ShardedStore,
                  max_size: int) -> Optional[torch.Tensor]:
    """ST.eviction_keep from the gathered usage (a float a slot)."""
    n_remove = store.size - max_size
    if n_remove <= 0:
        return None
    u = usage(store)[:store.size]
    threshold = torch.sort(u).values[n_remove - 1]
    return u > threshold


def evict_by_usage(store: ShardedStore, max_size: int) -> ShardedStore:
    keep = eviction_keep(store, max_size)
    return store if keep is None else _compact(store, keep)


def grow(store: ShardedStore, new_capacity: int, new_num_objects: int,
         new_num_groups: int) -> ShardedStore:
    """A new sharded store with more capacity / objects / groups on the same
    devices; the occupied rows move to the shards of their slots in the new
    layout, new objects and groups start invalid and zero."""
    o, g = store.num_objects, store.num_groups
    ref = store.shards[0]
    out = empty_store(new_capacity, new_num_objects, new_num_groups,
                      ref.key.shape[1], ref.value.shape[2], store.devices,
                      ref.value.dtype)
    for d, lo, hi, off in _pieces(out, 0, store.size):
        s = out.shards[d]
        src = torch.arange(off, off + hi - lo, device=store.devices[0])
        for name in FIELDS:
            rows = take(store, name, src, s.key.device)
            dst = getattr(s, name)
            if name == 'value':
                dst = dst[:o]
            elif name == 'val_valid':
                dst = dst[:g]
            _slot_slice(dst, name, lo, hi).copy_(rows)
    _set_size(out, store.size)
    return out
