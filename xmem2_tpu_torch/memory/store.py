"""Fixed-capacity key/value memory buffers.

Counterpart of xmem2_tpu/memory/store.py (reference
inference/kv_memory_store.py). Buffers of a store:

  key        [cap, Ck]      shared across objects
  shrinkage  [cap]
  selection  [cap, Ck]      kept for consolidation's potentiation step
  value      [O, cap, Cv]   per object (objects of a group share extent)
  val_valid  [G, cap] bool  per-group slot validity: a group that appeared
                            later has no data for older slots
  use_count  [cap] f32      usage statistics (use / life)
  life_count [cap] f32
  size       int            slots [0, size) are occupied

Unlike the JAX package, whose stores are immutable values threaded through
jit, these helpers UPDATE THE BUFFERS IN PLACE (and return the store for
convenience): the port runs eagerly, so copying a multi-megabyte bank per
frame would only cost bandwidth. `size` is a host integer.
"""

from dataclasses import dataclass
from typing import Optional

import torch

LIFE_EPS = 1e-7  # initial life count (reference kv_memory_store.py:38)


@dataclass
class StoreBuffers:
    key: torch.Tensor
    shrinkage: torch.Tensor
    selection: torch.Tensor
    value: torch.Tensor
    val_valid: torch.Tensor
    use_count: torch.Tensor
    life_count: torch.Tensor
    size: int = 0

    @property
    def capacity(self) -> int:
        return self.key.shape[0]

    @property
    def num_objects(self) -> int:
        return self.value.shape[0]

    @property
    def num_groups(self) -> int:
        return self.val_valid.shape[0]


def empty_store(capacity: int, num_objects: int, num_groups: int,
                key_dim: int, value_dim: int, device,
                value_dtype=torch.float32) -> StoreBuffers:
    f32 = dict(dtype=torch.float32, device=device)
    return StoreBuffers(
        key=torch.zeros((capacity, key_dim), **f32),
        shrinkage=torch.zeros((capacity,), **f32),
        selection=torch.zeros((capacity, key_dim), **f32),
        value=torch.zeros((num_objects, capacity, value_dim),
                          dtype=value_dtype, device=device),
        val_valid=torch.zeros((num_groups, capacity), dtype=torch.bool,
                              device=device),
        use_count=torch.zeros((capacity,), **f32),
        life_count=torch.full((capacity,), LIFE_EPS, **f32),
        size=0)


def append(store: StoreBuffers, key: torch.Tensor, shrinkage: torch.Tensor,
           selection: Optional[torch.Tensor], value: torch.Tensor,
           group_present: torch.Tensor) -> StoreBuffers:
    """Append one frame's n elements at [size, size + n), in place.

    key [n, Ck]; shrinkage [n]; selection [n, Ck] or None; value [O, n, Cv];
    group_present [G] or [G, n] bool: which groups have data for the slots
    (reference kv_memory_store.py:59-79)."""
    n = key.shape[0]
    at = store.size
    if at + n > store.capacity:
        raise ValueError(f'append of {n} slots overflows capacity '
                         f'{store.capacity} at size {at}')
    s = slice(at, at + n)
    store.key[s] = key
    store.shrinkage[s] = shrinkage
    if selection is not None:
        store.selection[s] = selection
    store.value[:, s] = value.to(store.value.dtype)
    if group_present.dim() == 1:
        group_present = group_present[:, None].expand(store.num_groups, n)
    store.val_valid[:, s] = group_present
    store.use_count[s] = 0.0
    store.life_count[s] = LIFE_EPS
    store.size = at + n
    return store


def replace_at(store: StoreBuffers, start: int, key: torch.Tensor,
               shrinkage: torch.Tensor, selection: Optional[torch.Tensor],
               value: torch.Tensor) -> StoreBuffers:
    """Overwrite the n slots from `start` in place (permanent-memory frame
    update, reference kv_memory_store.py:105-118); validity is unchanged."""
    s = slice(start, start + key.shape[0])
    store.key[s] = key
    store.shrinkage[s] = shrinkage
    if selection is not None:
        store.selection[s] = selection
    store.value[:, s] = value.to(store.value.dtype)
    return store


def _compact(store: StoreBuffers, keep: torch.Tensor) -> StoreBuffers:
    """Move the kept occupied slots (keep [size] bool) to the front in their
    original order, in place; freed slots become invalid and unused."""
    idx = torch.nonzero(keep).flatten()
    m = idx.numel()
    store.key[:m] = store.key[idx]
    store.shrinkage[:m] = store.shrinkage[idx]
    store.selection[:m] = store.selection[idx]
    store.value[:, :m] = store.value[:, idx]
    store.val_valid[:, :m] = store.val_valid[:, idx]
    store.use_count[:m] = store.use_count[idx]
    store.life_count[:m] = store.life_count[idx]
    store.val_valid[:, m:] = False
    store.use_count[m:] = 0.0
    store.life_count[m:] = LIFE_EPS
    store.size = m
    return store


def remove_range(store: StoreBuffers, start: int, end: int) -> StoreBuffers:
    """Drop slots [start, end) and compact, in place (reference
    sieve_by_range / remove_at, kv_memory_store.py:120-158)."""
    idx = torch.arange(store.size, device=store.key.device)
    return _compact(store, (idx < start) | (idx >= end))


def update_usage(store: StoreBuffers, usage: torch.Tensor,
                 frames: int = 1) -> StoreBuffers:
    """use += usage on occupied slots, life += frames, in place. usage
    covers at least the occupied prefix (reference kv_memory_store.py:96-103;
    a batched readout over k frames passes its summed usage with frames=k,
    landing on the totals of k sequential updates)."""
    n = store.size
    store.use_count[:n] += usage[:n]
    store.life_count[:n] += frames
    return store


def usage(store: StoreBuffers) -> torch.Tensor:
    return store.use_count / store.life_count


def take(store: StoreBuffers, name: str, idx: torch.Tensor) -> torch.Tensor:
    """Field `name` at the slots idx (memory/sharded_store.py has the same
    function over shards)."""
    t = getattr(store, name)
    return t[:, idx] if name in ('value', 'val_valid') else t[idx]


def prefix_pieces(store: StoreBuffers, n: int):
    """(key, shrinkage, values, validity) views of the slots [0, n), as a
    list of one (a sharded store gives one per shard)."""
    return [(store.key[:n], store.shrinkage[:n], store.value[:, :n],
             store.val_valid[:, :n])]


def eviction_keep(store: StoreBuffers,
                  max_size: int) -> Optional[torch.Tensor]:
    """Which occupied slots evict_by_usage(store, max_size) keeps (bool
    [size]), or None when it drops nothing: survivors are strictly above
    the k-th smallest usage, k = size - max_size (reference
    remove_obsolete_features, kv_memory_store.py:160-181)."""
    n_remove = store.size - max_size
    if n_remove <= 0:
        return None
    u = usage(store)[:store.size]
    threshold = torch.sort(u).values[n_remove - 1]
    return u > threshold


def evict_by_usage(store: StoreBuffers, max_size: int) -> StoreBuffers:
    """Keep at most max_size slots, dropping the least used, in place
    (eviction_keep; order kept). Validity masks carry multi-group stores
    along."""
    keep = eviction_keep(store, max_size)
    return store if keep is None else _compact(store, keep)


def grow(store: StoreBuffers, new_capacity: int, new_num_objects: int,
         new_num_groups: int) -> StoreBuffers:
    """A new store with more capacity / objects / groups; new rows start
    invalid and zero (rare: permanent-memory growth, new objects)."""
    o, cap, cv = store.value.shape
    g = store.num_groups
    out = empty_store(new_capacity, new_num_objects, new_num_groups,
                      store.key.shape[1], cv, store.key.device,
                      store.value.dtype)
    out.key[:cap] = store.key
    out.shrinkage[:cap] = store.shrinkage
    out.selection[:cap] = store.selection
    out.value[:o, :cap] = store.value
    out.val_valid[:g, :cap] = store.val_valid
    out.use_count[:cap] = store.use_count
    out.life_count[:cap] = store.life_count
    out.size = store.size
    return out
