"""MemoryManager: permanent, working and long-term stores, working->long-term
consolidation.

Counterpart of xmem2_tpu/memory/manager.py (reference
inference/memory_manager.py: match_memory :61, add_memory :212,
compress_features :316, consolidation :349, update/remove permanent
:192/:204, copy_perm_mem_only :392), with the JAX package's host spill of
evicted long-term rows (`spill_long_term`, memory/spill.py) and the JAX
package's memory-bank sharding (`memory_shards`, parallel/).

The readout path follows the device and nothing else: CUDA tensors go through
the hand-written kernels (ops/readout_kernel.py), CPU tensors through their
plain versions. Each match is computed over the occupied prefix of each store
only (the JAX package buckets that width to bound XLA recompiles; eager
PyTorch has no recompiles, and unoccupied slots carry no weight).

With memory_shards = D > 1 every store is split by slot range over D
devices (memory/sharded_store.py; capacities rounded up to a multiple of D,
as in JAX manager.py:351-356) and the match is the sharded readout over the
shards' full capacity (parallel/sharded_readout.py; JAX _match_sharded
:526-553). One manager drives every shard, so consolidation and eviction
keep their global view: they plan on the first device from per-slot
metadata and apply the plan shard by shard.

Known deviations from the reference, kept from the JAX package (both are
reference bugs):
  1. Multi-group + long-term: the reference assumes a group's long-term values
     align to the key suffix although consolidation appends a usage-ranked
     subset (memory_manager.py:105-126). Per-slot masks track true
     validity; single-group behaviour matches the reference exactly.
  2. Permanent frame slots: the reference computes the slot of a new
     permanent frame as int((total+1e-9)//(frame+1e-9))-1
     (kv_memory_store.py:92), one short for every frame after the first, so
     update/remove hit the wrong frame. Slots are tracked correctly here.
  3. Permanent frame update: the reference broadcasts object 0's values over
     all objects of a group (kv_memory_store.py:112). Each object's values
     are updated here.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from xmem2_tpu_torch.config import resolve_device, resolve_dtype_name, \
    torch_dtype
from xmem2_tpu_torch.memory import sharded_store as SS
from xmem2_tpu_torch.memory import store as ST
from xmem2_tpu_torch.memory.spill import HostArchive
from xmem2_tpu_torch.memory.store import StoreBuffers
from xmem2_tpu_torch.ops.readout_kernel import fused_topk_readout_multi
from xmem2_tpu_torch.ops.similarity import get_similarity, masked_softmax
from xmem2_tpu_torch.parallel.mesh import memory_devices
from xmem2_tpu_torch.parallel.sharded_readout import \
    sharded_topk_readout_multi
from xmem2_tpu_torch.utils.profiling import annotate, count


def _prefix(s: StoreBuffers, n: int):
    """(key, shrinkage, values, validity) of the first n slots (views)."""
    return s.key[:n], s.shrinkage[:n], s.value[:, :n], s.val_valid[:, :n]


def _match_kernel(temp: StoreBuffers, perm: StoreBuffers,
                  long: Optional[StoreBuffers], qk: torch.Tensor,
                  qe: Optional[torch.Tensor], *, group_ids: Tuple[int, ...],
                  top_k: int, use_long: bool, count_usage: bool,
                  count_long_usage: bool, use_perm: bool = True,
                  usage_frames: int = 1) -> torch.Tensor:
    """Readout over [long | temp | perm] with a per-group top-k softmax.

    qk/qe: [P, Ck]. Returns readout [O, P, Cv] f32 and, when counted, adds the
    group-0 usage to temp (and long) in place (reference match_memory,
    memory_manager.py:61-190). usage_frames: life-count advance; a batched
    readout over k frames' queries passes k, reproducing the totals of k
    sequential readouts (use is additive over queries, and affinities never
    read usage)."""
    stores = ([long] if use_long else []) + [temp] + ([perm] if use_perm
                                                     else [])
    ti = 1 if use_long else 0
    want = [False] * len(stores)
    if use_long and count_long_usage:
        want[0] = True
    if count_usage:
        want[ti] = True
    segments = [_prefix(s, s.size) for s in stores]
    out, usages = fused_topk_readout_multi(segments, qk, qe, group_ids, top_k,
                                           want_usage=want)
    if use_long and count_long_usage:
        ST.update_usage(long, usages[0], frames=usage_frames)
    if count_usage:
        ST.update_usage(temp, usages[ti], frames=usage_frames)
    return out


def _match_sharded(temp: SS.ShardedStore, perm: SS.ShardedStore,
                   long: Optional[SS.ShardedStore], qk: torch.Tensor,
                   qe: Optional[torch.Tensor], *, group_ids: Tuple[int, ...],
                   top_k: int, use_long: bool, count_usage: bool,
                   count_long_usage: bool, use_perm: bool = True,
                   usage_frames: int = 1) -> torch.Tensor:
    """_match_kernel over sharded stores: the sharded readout over every
    shard's full capacity (validity masks exclude free slots) and the usage
    added shard by shard. A store with nothing in it takes no part."""
    stores = ([long] if use_long else []) + [temp] + ([perm] if use_perm
                                                     else [])
    ti = 1 if use_long else 0
    want = [False] * len(stores)
    if use_long and count_long_usage:
        want[0] = True
    if count_usage:
        want[ti] = True
    live = [i for i, s in enumerate(stores) if s.size > 0]
    if not live:
        return torch.zeros((len(group_ids), qk.shape[0],
                            temp.shards[0].value.shape[2]),
                           dtype=torch.float32, device=qk.device)
    segments = [[(s.key, s.shrinkage, s.value, s.val_valid)
                 for s in stores[i].shards] for i in live]
    out, usages = sharded_topk_readout_multi(
        segments, qk, qe, group_ids, top_k, want_usage=[want[i] for i in live])
    for i, u in zip(live, usages):
        if u is not None:
            SS.update_usage(stores[i], u, frames=usage_frames)
    return out


def _consolidate_kernel(temp, long, *, num_prototypes: int,
                        min_work_elements: int, group_ids: Tuple[int, ...],
                        S=ST):
    """Working -> long-term consolidation, in place (reference
    compress_features + consolidation, memory_manager.py:316-390):
      1. candidates = slots [0, size - min_work_elements)
      2. prototypes = the num_prototypes most used candidates
      3. potentiation: prototype values = candidate values attended onto the
         prototype keys (dense softmax per object group)
      4. prototypes appended to long-term; the candidate range is removed
    Plain PyTorch, as the JAX package's is plain jnp. S: the stores' module
    (memory/store.py, or memory/sharded_store.py for sharded stores, whose
    candidates are matched shard by shard: the similarities and the softmax
    are gathered on the first device, the value products summed there)."""
    cand_end = temp.size - min_work_elements
    u = S.usage(temp)[:temp.size].clone()
    u[cand_end:] = -torch.inf
    if u.numel() < num_prototypes:
        u = torch.nn.functional.pad(u, (0, num_prototypes - u.numel()),
                                    value=-torch.inf)
    # stable descending sort: equal usages keep slot order, as lax.top_k
    order = torch.sort(u, descending=True, stable=True)
    top_vals = order.values[:num_prototypes]
    proto_idx = order.indices[:num_prototypes]
    proto_ok = top_vals > -torch.inf

    proto_key = S.take(temp, 'key', proto_idx)
    proto_sel = S.take(temp, 'selection', proto_idx)
    dev = proto_key.device
    pieces = S.prefix_pieces(temp, max(cand_end, 0))
    sim = torch.cat([get_similarity(k, s, proto_key.to(k.device),
                                    proto_sel.to(k.device)).to(dev)
                     for k, s, _, _ in pieces], dim=1)        # [P, n]
    g_valid = torch.cat([e.to(dev) for _, _, _, e in pieces], dim=1)
    aff = torch.stack([masked_softmax(sim, valid=g_valid[g])
                       for g in range(g_valid.shape[0])])     # [G, P, n]
    proto_value = proto_shrinkage = 0
    at = 0
    for k, s, v, _ in pieces:
        a = aff[:, :, at:at + k.shape[0]].to(k.device)
        at += k.shape[0]
        proto_value = proto_value + torch.stack([
            a[g] @ v[o].float()
            for o, g in enumerate(group_ids)]).to(dev)        # [O, P, Cv]
        proto_shrinkage = proto_shrinkage + (a[0] @ s).to(dev)  # [P]
    proto_group_valid = S.take(temp, 'val_valid', proto_idx) \
        & proto_ok[None, :]

    S.append(long, proto_key, proto_shrinkage, None, proto_value,
             proto_group_valid)
    S.remove_range(temp, 0, cand_end)


class MemoryManager:
    """Host-side orchestrator with the reference MemoryManager's API. Runs
    on CUDA unless `device` says otherwise (config.resolve_device)."""

    def __init__(self, config: dict, device=None, shard_devices=None):
        """shard_devices: with memory_shards = D > 1, the D devices of the
        shards (repeats allowed: several shards on one card); by default the
        first D devices of `device`'s kind (parallel/mesh.py), raising when
        fewer are visible."""
        self.config = config
        self.device = resolve_device(device)
        self.memory_shards = int(config.get('memory_shards', 0) or 0)
        self.shard_devices = None
        if self.memory_shards > 1:
            self.shard_devices = memory_devices(
                self.memory_shards, self.device) if shard_devices is None \
                else [torch.device(d) for d in shard_devices]
            if len(self.shard_devices) != self.memory_shards:
                raise ValueError(f'{len(self.shard_devices)} shard devices '
                                 f'for memory_shards={self.memory_shards}')
        # the stores' module: plain or sharded stores
        self.S = SS if self.sharded else ST
        self.hidden_dim = config['hidden_dim']
        self.top_k = config['top_k']

        self.enable_long_term = config['enable_long_term']
        self.enable_long_term_usage = config['enable_long_term_count_usage']
        if self.enable_long_term:
            self.max_mt_frames = config['max_mid_term_frames']
            self.min_mt_frames = config['min_mid_term_frames']
            self.num_prototypes = config['num_prototypes']
            self.max_long_elements = config['max_long_term_elements']
        self.perm_bucket_frames = config.get('permanent_buffer_frames', 4)
        # bf16 value banks halve memory and readout traffic (the analog of
        # the reference's fp16 autocast); float32 for parity runs
        self.value_dtype = torch_dtype(resolve_dtype_name(
            config.get('value_store_dtype', 'auto'), self.device))
        # evicted long-term rows go to a host archive instead of away
        self.spill_long_term = bool(config.get('spill_long_term', False))
        self.archive = HostArchive() if self.spill_long_term else None

        self.CK = self.CV = None
        self.H = self.W = self.HW = None
        self.hidden: Optional[torch.Tensor] = None   # [1, O, Ch, h, w]

        self.temp: Optional[StoreBuffers] = None
        self.perm: Optional[StoreBuffers] = None
        self.long: Optional[StoreBuffers] = None

        self.perm_size = 0
        self.obj_groups: List[List[int]] = []   # 0-based object ids per group
        self.all_objects: List[int] = []
        self.frame_id_to_permanent_mem_idx: Dict[int, int] = {}
        self.reset_config = True

    # -- sizes (the stores' own host integers) ------------------------------
    @property
    def temp_size(self) -> int:
        return self.temp.size if self.temp is not None else 0

    @property
    def long_size(self) -> int:
        return self.long.size if self.long is not None else 0

    # -- config ------------------------------------------------------------
    def update_config(self, config: dict):
        self.reset_config = True
        self.hidden_dim = config['hidden_dim']
        self.top_k = config['top_k']
        if self.enable_long_term != config['enable_long_term']:
            raise ValueError('enable_long_term cannot change on a live memory')
        self.enable_long_term_usage = config['enable_long_term_count_usage']
        if self.enable_long_term:
            old_max_long = self.max_long_elements
            self.max_mt_frames = config['max_mid_term_frames']
            self.min_mt_frames = config['min_mid_term_frames']
            self.num_prototypes = config['num_prototypes']
            self.max_long_elements = config['max_long_term_elements']
            # a raised cap needs the room (the store is allocated at the
            # cap) and is the moment to pull spilled rows back (JAX
            # manager.py:334-344)
            if self.long is not None and self.max_long_elements > old_max_long:
                need = self.max_long_elements + self.num_prototypes
                if self.long.capacity < need:
                    self.long = self.S.grow(
                        self.long, self._round_shards(need),
                        self.long.num_objects, self.long.num_groups)
                self.revive_from_archive()

    # -- helpers -----------------------------------------------------------
    @property
    def sharded(self) -> bool:
        return self.shard_devices is not None

    def _round_shards(self, cap: int) -> int:
        """A capacity rounded up to a multiple of the shard count."""
        if not self.sharded:
            return cap
        d = self.memory_shards
        return -(-cap // d) * d

    @property
    def num_groups(self) -> int:
        return len(self.obj_groups)

    @property
    def num_objects(self) -> int:
        return len(self.all_objects)

    @property
    def group_ids(self) -> Tuple[int, ...]:
        gids = [0] * self.num_objects
        for gi, group in enumerate(self.obj_groups):
            for o in group:
                gids[self.all_objects.index(o)] = gi
        return tuple(gids)

    def _ensure_dims(self, key: torch.Tensor):
        """key [1, Ck, h, w]."""
        if self.H is None or self.reset_config:
            self.reset_config = False
            self.H, self.W = key.shape[-2:]
            self.HW = self.H * self.W
            if self.enable_long_term:
                self.min_work_elements = self.min_mt_frames * self.HW
                self.max_work_elements = self.max_mt_frames * self.HW
            else:
                self.min_work_elements = self.max_work_elements = None

    def _temp_capacity(self) -> int:
        if self.enable_long_term:
            return self._round_shards(self.max_work_elements + self.HW)
        # without long-term memory the working store is unbounded: grow by
        # doubling from 32 frames
        need = max(self.temp_size + self.HW, 32 * self.HW)
        cap = 32 * self.HW
        while cap < need:
            cap *= 2
        return self._round_shards(cap)

    def _perm_capacity(self) -> int:
        need = max(self.perm_size + self.HW, self.perm_bucket_frames * self.HW)
        cap = self.perm_bucket_frames * self.HW
        while cap < need:
            cap *= 2
        return self._round_shards(cap)

    def _new_store(self, capacity: int):
        where = self.shard_devices if self.sharded else self.device
        return self.S.empty_store(capacity, max(self.num_objects, 1),
                                  max(self.num_groups, 1), self.CK, self.CV,
                                  where, value_dtype=self.value_dtype)

    def _ensure_stores(self):
        o, g = max(self.num_objects, 1), max(self.num_groups, 1)
        if self.temp is None:
            self.temp = self._new_store(self._temp_capacity())
        if self.perm is None:
            self.perm = self._new_store(self._perm_capacity())
        if self.enable_long_term and self.long is None:
            self.long = self._new_store(self._round_shards(
                self.max_long_elements + self.num_prototypes))

        def fit(s, cap: int):
            if s.capacity < cap or s.num_objects < o or s.num_groups < g:
                return self.S.grow(s, max(s.capacity, cap),
                                   max(s.num_objects, o), max(s.num_groups, g))
            return s

        self.temp = fit(self.temp, self._temp_capacity())
        self.perm = fit(self.perm, self._perm_capacity())
        if self.long is not None:
            self.long = fit(self.long, self.long.capacity)

    def _register_objects(self, objects: List[int]):
        """objects: 1-based labels (background excluded). New labels form a
        new group (reference kv_memory_store.py:59-79)."""
        remaining = [o - 1 for o in objects if o - 1 not in self.all_objects]
        if remaining:
            self.obj_groups.append(list(remaining))
            self.all_objects.extend(remaining)
            if sorted(self.all_objects) != self.all_objects:
                raise ValueError('objects must be inserted in sorted order')

    def _group_presence(self) -> torch.Tensor:
        """All currently known groups receive data for a newly added frame."""
        return torch.ones((max(self.num_groups, 1),), dtype=torch.bool,
                          device=self.device)

    # -- public API (reference parity) --------------------------------------
    def match_config(self, disable_usage_updates: bool = False) -> dict:
        """Keyword set for _match_kernel at the current occupancy/topology.
        Empty stores are left out of the match (temp stays as the fallback
        when everything is empty)."""
        use_long = self.enable_long_term and self.long_size > 0
        count_usage = self.enable_long_term and not disable_usage_updates
        count_long_usage = (use_long and self.enable_long_term_usage
                            and not disable_usage_updates)
        return dict(group_ids=self.group_ids, top_k=self.top_k,
                    use_long=use_long, count_usage=count_usage,
                    count_long_usage=count_long_usage,
                    use_perm=self.perm_size > 0)

    def match_query(self, qk: torch.Tensor, qe: Optional[torch.Tensor],
                    disable_usage_updates: bool = False,
                    usage_frames: int = 1) -> torch.Tensor:
        """qk/qe [P, Ck] -> readout [O, P, Cv] f32. Counts the readout, its
        query rows and the query rows times the slots it reads."""
        with annotate('xmem.readout'):
            cfg = self.match_config(disable_usage_updates)
            slots = self.temp_size \
                + (self.long_size if cfg['use_long'] else 0) \
                + (self.perm_size if cfg['use_perm'] else 0)
            count('readouts')
            count('readout.query_rows', qk.shape[0])
            count('readout.slot_rows', qk.shape[0] * slots)
            match = _match_sharded if self.sharded else _match_kernel
            return match(self.temp, self.perm, self.long, qk, qe,
                         usage_frames=usage_frames, **cfg)

    def match_memory(self, query_key: torch.Tensor,
                     selection: Optional[torch.Tensor],
                     disable_usage_updates: bool = False) -> torch.Tensor:
        """query_key/selection [1, Ck, h, w] -> readout [1, O, Cv, h, w]."""
        h, w = query_key.shape[-2:]
        qk = query_key[0].flatten(1).T
        qe = selection[0].flatten(1).T if selection is not None else None
        out = self.match_query(qk, qe, disable_usage_updates)
        return out.reshape(self.num_objects, h, w, self.CV) \
            .permute(0, 3, 1, 2)[None]

    def add_memory(self, key, shrinkage, value, objects: List[int],
                   selection=None, permanent: bool = False,
                   ignore: bool = False, ti: Optional[int] = None):
        """key [1, Ck, h, w]; shrinkage [1, 1, h, w]; value [1, O, Cv, h, w];
        objects: 1-based labels (reference add_memory, memory_manager.py
        :212)."""
        self._ensure_dims(key)
        self.CK = key.shape[1]
        self.CV = value.shape[2]
        self._register_objects(objects)
        self._ensure_stores()
        if ignore:
            return

        k = key[0].flatten(1).T
        s = shrinkage.reshape(-1)
        v = value[0].flatten(2).transpose(1, 2)                 # [O, HW, Cv]
        e = selection[0].flatten(1).T if selection is not None else None
        count('memory.appends')
        if permanent:
            pos = self.perm_size // self.HW
            with annotate('xmem.memory.append'):
                self.S.append(self.perm, k, s, e, v, self._group_presence())
            self.perm_size += self.HW
            if ti is not None:
                self.frame_id_to_permanent_mem_idx[ti] = pos
        else:
            with annotate('xmem.memory.append'):
                self.S.append(self.temp, k, s, e, v, self._group_presence())
            self.note_temp_append()

    def note_temp_append(self):
        """After one frame was appended to working memory: overflow handling
        (eviction + consolidation, reference memory_manager.py:272-281)."""
        if not (self.enable_long_term
                and self.temp_size >= self.max_work_elements):
            return
        with annotate('xmem.memory.consolidate'):
            if self.long_size >= self.max_long_elements - self.num_prototypes:
                max_keep = self.max_long_elements - self.num_prototypes
                if self.spill_long_term:
                    self._spill_evicted(max_keep)
                before = self.long_size
                self.S.evict_by_usage(self.long, max_keep)
                count('memory.evicted_slots', before - self.long_size)
            count('memory.consolidations')
            self.compress_features()

    def _spill_evicted(self, max_keep: int):
        """Archive exactly the rows the following ST.evict_by_usage drops
        (ST.eviction_keep, the rule it applies), with their usage as revival
        priority, in one device-to-host copy (JAX manager.py:603-623)."""
        long, S = self.long, self.S
        keep = S.eviction_keep(long, max_keep)
        if keep is None:
            return
        n, drop = long.size, torch.nonzero(~keep).flatten()
        o, g = long.num_objects, long.num_groups
        ck, cv = self.CK, self.CV
        rows = torch.cat([
            S.take(long, 'key', drop),
            S.take(long, 'shrinkage', drop)[:, None],
            S.usage(long)[:n][drop, None],
            S.take(long, 'val_valid', drop).T.float(),
            S.take(long, 'value', drop).float().transpose(0, 1).flatten(1),
        ], dim=1).cpu().numpy()
        key, shrinkage, use, valid, value = np.split(
            rows, np.cumsum([ck, 1, 1, g]), axis=1)
        self.archive.archive(
            key, shrinkage[:, 0],
            value.reshape(-1, o, cv).transpose(1, 0, 2), valid.T > 0.5,
            use[:, 0])

    def revive_from_archive(self, query_key: Optional[torch.Tensor] = None,
                            max_elements: Optional[int] = None) -> int:
        """Re-upload the most relevant archived long-term rows into free
        long-term capacity (JAX manager.py:625-648). query_key: the current
        frame's key [1, Ck, h, w] (or [P, Ck]) to rank the rows by
        (HostArchive.scores); without it the most used rows revive. Returns
        how many rows were revived."""
        if not self.spill_long_term or self.archive.empty or self.long is None:
            return 0
        free = (self.max_long_elements - self.num_prototypes) - self.long_size
        n = free if max_elements is None else min(free, max_elements)
        if n <= 0:
            return 0
        qk = None
        if query_key is not None:
            q = query_key[0].flatten(1).T if query_key.dim() == 4 \
                else query_key
            qk = q.float().cpu().numpy()
        rows = self.archive.take_top(n, qk)
        if rows is None:
            return 0
        key, shrinkage, value, val_valid = (
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in rows)
        # objects and groups that appeared after the rows were archived have
        # no data in them
        m = key.shape[0]
        v = value.new_zeros((self.long.num_objects, m, value.shape[2]))
        v[:value.shape[0]] = value
        e = val_valid.new_zeros((self.long.num_groups, m))
        e[:val_valid.shape[0]] = val_valid
        self.S.append(self.long, key, shrinkage, None, v, e)
        return m

    def compress_features(self):
        """Consolidate working memory into long-term prototypes."""
        _consolidate_kernel(self.temp, self.long,
                            num_prototypes=self.num_prototypes,
                            min_work_elements=self.min_work_elements,
                            group_ids=self.group_ids, S=self.S)

    def update_permanent_memory(self, frame_idx: int, key, shrinkage, value,
                                selection=None):
        saved_pos = self.frame_id_to_permanent_mem_idx[frame_idx]
        k = key[0].flatten(1).T
        s = shrinkage.reshape(-1)
        v = value[0].flatten(2).transpose(1, 2)
        e = selection[0].flatten(1).T if selection is not None else None
        self.S.replace_at(self.perm, saved_pos * self.HW, k, s, e, v)

    def remove_from_permanent_memory(self, frame_idx: int):
        saved_pos = self.frame_id_to_permanent_mem_idx[frame_idx]
        start = saved_pos * self.HW
        self.S.remove_range(self.perm, start, start + self.HW)
        self.perm_size -= self.HW
        del self.frame_id_to_permanent_mem_idx[frame_idx]
        # surviving frames shift down one slot
        self.frame_id_to_permanent_mem_idx = {
            fi: (pos - 1 if pos > saved_pos else pos)
            for fi, pos in self.frame_id_to_permanent_mem_idx.items()}

    def frame_already_saved(self, ti) -> bool:
        return ti in self.frame_id_to_permanent_mem_idx

    # -- hidden state --------------------------------------------------------
    def create_hidden_state(self, n: int, sample_key: torch.Tensor):
        """n = total number of objects; sample_key [1, Ck, h, w]
        (reference memory_manager.py:283-294)."""
        h, w = sample_key.shape[-2:]
        shape = (1, n, self.hidden_dim, h, w)
        if self.hidden is None:
            self.hidden = torch.zeros(shape, device=self.device)
        elif self.hidden.shape[1] != n:
            extra = torch.zeros((1, n - self.hidden.shape[1]) + shape[2:],
                                device=self.device)
            self.hidden = torch.cat([self.hidden, extra], dim=1)

    def set_hidden(self, hidden):
        self.hidden = hidden

    def get_hidden(self):
        return self.hidden

    @property
    def work_mem_engaged(self) -> bool:
        return self.temp_size > 0 or self.perm_size > 0

    def copy_perm_mem_only(self) -> 'MemoryManager':
        """Fresh manager sharing the permanent store (full re-propagation,
        reference memory_manager.py:392-425)."""
        new = MemoryManager(self.config, self.device, self.shard_devices)
        if self.perm is None or self.perm_size == 0:
            return new
        new.perm = self.perm
        new.perm_size = self.perm_size
        new.frame_id_to_permanent_mem_idx = dict(
            self.frame_id_to_permanent_mem_idx)
        new.obj_groups = [list(g) for g in self.obj_groups]
        new.all_objects = list(self.all_objects)
        new.CK, new.CV = self.CK, self.CV
        new.H, new.W, new.HW = self.H, self.W, self.HW
        if self.enable_long_term:
            new.min_work_elements = self.min_work_elements
            new.max_work_elements = self.max_work_elements
        new.reset_config = False
        new._ensure_stores()
        sample = torch.zeros((1, self.CK, self.H, self.W),
                             device=self.device)
        new.create_hidden_state(len(self.all_objects), sample)
        return new
