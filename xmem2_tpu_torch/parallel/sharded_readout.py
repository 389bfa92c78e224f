"""Exact top-k readout over memory banks split by slot range across devices.

Counterpart of xmem2_tpu/parallel/sharded_readout.py (sharded_topk_readout
:73, sharded_topk_readout_multi :169, shard_memory_bank :219), with the JAX
signatures minus the mesh: a sharded tensor is a list of per-shard tensors,
each on its own device. JAX runs one SPMD program under shard_map (per-shard
candidates, an all_gather, the stats on every chip, a psum). Here one
process drives the shards through the kernels of the single-device path
(ops/readout_kernel.py). Per match:

  1. each shard computes each segment's similarity on its own device;
  2. one K2 launch per (segment, shard) gives its [G, P, k] top-k values
     and k-th-value counts;
  3. those lists are copied to the first device and concatenated;
  4. one grouped K2 launch merges them ([G, P, D*S*k] -> [G, P, k]);
  5. the closed-form tie count gives tau, rmax and 1/Z there. Sharding a
     segment is splitting it into D more segments, so steps 2-5 are
     _topk_stats_fused over the (segment, shard) pieces;
  6. the stats are copied to every shard's device;
  7. K1 (readout and usage) runs per piece on its device;
  8. the partial readouts are summed on the first device.

Ties at the k-th value: as on one device, every slot >= tau is kept and the
tie count is folded into Z, so the sharded readout equals the unsharded one,
ties included. The JAX sharded body keeps every slot >= tau too but
normalises by the k values alone (:141-155), so its weights sum to more than
1 when a tie runs past k (ROADMAP.md standing departures). A shard smaller
than k: K2 pads its list with -inf where JAX clamps k per shard (:132-141);
the top-k of the union is the same.
"""

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch

from xmem2_tpu_torch.ops import readout_kernel as RK
from xmem2_tpu_torch.ops.similarity import get_similarity_padded

Piece = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
              torch.Tensor]


def on_device(device: torch.device):
    """The current CUDA device set to `device` for a hand-written kernel's
    launch (PyTorch's own ops guard their device themselves)."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _candidates(sim, valid, k):
    with on_device(sim.device):
        return RK.block_topk_candidates(sim, valid, k)


def sharded_topk_readout_multi(
    segments: Sequence[Sequence[Piece]],
    qk: torch.Tensor, qe: Optional[torch.Tensor],
    group_ids: Tuple[int, ...], top_k: int,
    want_usage: Optional[Sequence[bool]] = None,
) -> Tuple[torch.Tensor, List[Optional[List[torch.Tensor]]]]:
    """One global top-k over several segments, each split into shards.

    segments: per segment, per shard (mk [N_d, Ck], ms [N_d] or None,
    values [O, N_d, Cv], valid [G, N_d] bool), each shard on its own device;
    qk / qe [P, Ck]. Returns (readout [O, P, Cv] f32 on qk's device, per
    segment the usage [N_d] f32 of each shard on its device, or None where
    want_usage says so)."""
    p = qk.shape[0]
    o, _, cv = segments[0][0][2].shape
    if want_usage is None:
        want_usage = [True] * len(segments)
    pieces = [(si, di, piece) for si, shards in enumerate(segments)
              for di, piece in enumerate(shards)]
    queries = {}
    sims, valids = [], []
    for _, _, (mk, ms, _, valid) in pieces:
        dev = mk.device
        if dev not in queries:
            queries[dev] = (qk.to(dev), None if qe is None else qe.to(dev))
        q, e = queries[dev]
        sims.append(get_similarity_padded(mk, ms, q, e, p, mk.shape[0]))
        valids.append(valid.contiguous())
    stats = RK._topk_stats_fused(sims, valids, top_k, candidates=_candidates)

    out = torch.zeros((o, p, cv), dtype=torch.float32, device=qk.device)
    usages = [[None] * len(shards) if want else None
              for shards, want in zip(segments, want_usage)]
    local = {}
    for (si, di, (_, _, values, _)), sim, valid in zip(pieces, sims, valids):
        dev = sim.device
        if dev not in local:
            local[dev] = tuple(s.to(dev) for s in stats)
        tau, rmax, invz = local[dev]
        with on_device(dev):
            out += RK.topk_readout(sim, values.contiguous(), valid, tau, rmax,
                                   invz, tuple(group_ids)).to(qk.device)
            if want_usage[si]:
                usages[si][di] = RK.topk_usage(sim, valid, tau, rmax, invz)
    return out, usages


def sharded_topk_readout(mk: Sequence[torch.Tensor],
                         ms: Optional[Sequence[torch.Tensor]],
                         qk: torch.Tensor, qe: Optional[torch.Tensor],
                         values: Sequence[torch.Tensor],
                         valid: Sequence[torch.Tensor],
                         group_ids: Tuple[int, ...], top_k: int):
    """The single-segment readout over a bank that shard_memory_bank split:
    (readout [O, P, Cv] f32, [usage [N_d] f32 per shard])."""
    shards = [(k, None if ms is None else s, v, va) for k, s, v, va in
              zip(mk, ms if ms is not None else mk, values, valid)]
    out, usages = sharded_topk_readout_multi([shards], qk, qe, group_ids,
                                             top_k)
    return out, usages[0]


def shard_memory_bank(mk: torch.Tensor, ms: Optional[torch.Tensor],
                      values: torch.Tensor, valid: torch.Tensor,
                      devices: Sequence) -> Tuple[list, Optional[list], list,
                                                  list]:
    """Split a bank's slot axis into len(devices) equal ranges, range d on
    devices[d]: (mk, ms, values, valid), each a list of per-shard tensors.
    The slot count must divide the number of shards, as in JAX."""
    d = len(devices)
    n = mk.shape[0]
    if n % d:
        raise ValueError(f'{n} memory slots do not divide {d} shards')
    c = n // d

    def split(t, dim):
        return [t.narrow(dim, i * c, c).to(devices[i]).contiguous()
                for i in range(d)]

    return (split(mk, 0), None if ms is None else split(ms, 0),
            split(values, 1), split(valid, 1))
