"""The memory readout hot path: two hand-written CUDA kernels and their
plain PyTorch versions.

Counterpart of xmem2_tpu/ops/readout_kernel.py. The per-frame hot op
(reference model/memory_util.py:7-80 + inference/memory_manager.py:61-190) is
the similarity between the query frame and every memory slot, a top-k softmax
per object group, the value readout and the usage count. Split of work:

  1. A plain f32 product computes the similarity [P, N] of each memory
     segment (get_similarity_padded, no padding).
  2. K2, `block_topk_candidates` (csrc/block_topk.cu), reads each segment's
     similarity once for all groups and returns each row's exact top-k values
     and the count of its k-th value; one more launch merges the segments'
     lists. The k values give each row's softmax stats in closed form: the
     row max, the k-th value tau and 1/Z, with the tie count folded in
     without any dense pass (_tie_count_closed).
  3. K1, `topk_readout` and `topk_usage` (csrc/topk_readout.cu), apply those
     shared stats per segment: threshold mask, exp, normalisation, the
     per-object value readout (a gather of the value rows with weight) and
     the group-0 usage sum. No dense affinity is ever stored.

Each wrapper takes its plain version for a tensor on the CPU and its kernel
for a tensor on a CUDA device, and counts the launches of its kernel in the
counters of utils/profiling.py ('kernel.<wrapper>'). There is no fallback
from a CUDA tensor to the plain version.

Any number of objects and groups: a CTA handles at most CHUNK_GROUPS groups
(K2 keeps their running top-k in registers, K1 their hit lists in shared
memory) and K1 at most CHUNK_OBJECTS objects, so both kernels take a grid
dimension over chunks, in one launch a call. K2 splits the groups into equal
chunks (plan_group_width); K1 splits the objects into the consecutive ranges
of plan_object_chunks, passed to the kernel as a table of (object range,
global group ids, local group id of each object) that holds K1_TABLE_CHUNKS
chunks (1,024 objects at the least; past that, one launch a table). With
G <= 8 and O <= 64 each plan is one chunk and the launch is the one it was
before chunking. The *_chunked functions compute the same decomposition in
PyTorch.

Ties at the k-th value: like the JAX kernels, the streamed pass includes the
WHOLE tied set and folds the tie count into Z (_stats_from_vals), so weights
sum to exactly 1; the dense reference (similarity.softmax_w_top) keeps an
arbitrary k-subset of the tie.
"""

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from xmem2_tpu_torch.ops import cuda_build
from xmem2_tpu_torch.ops.similarity import (
    NEG_INF, get_similarity_padded, top_k_values)
from xmem2_tpu_torch.utils.profiling import count

BN = 512  # the JAX package's memory tile: widths count padded to it
CHUNK_GROUPS = 8      # groups a CTA of K1 or K2 handles
CHUNK_OBJECTS = 64    # objects a CTA of K1 gathers
K1_TABLE_CHUNKS = 16  # object chunks one K1 launch takes (its table is a
                      # kernel parameter; csrc/topk_readout.cu kMaxChunks)

def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_cuda(name: str, device: torch.device, **tensors):
    """Device, dtype and contiguity checks before a raw pointer is handed to
    a kernel."""
    for key, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f'{name}: {key} is on {t.device}, expected {device}')
        if t.dtype not in dtype:
            raise TypeError(f'{name}: {key} has dtype {t.dtype}, expected '
                            f'one of {dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {key} must be contiguous')


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error {rc}')


def plan_group_width(g: int) -> int:
    """Groups per K2 CTA: the G groups in ceil(G / CHUNK_GROUPS) chunks of
    this width (the last may be narrower). G <= 8: G, one chunk."""
    n = -(-g // CHUNK_GROUPS)
    return -(-g // n)


def plan_object_chunks(group_ids: Sequence[int]
                       ) -> List[Tuple[int, int, Tuple[int, ...]]]:
    """K1's object chunks: consecutive ranges [o0, o1) covering every
    object once, in order, each holding at most CHUNK_OBJECTS objects and
    touching at most CHUNK_GROUPS distinct groups, with the range's
    distinct global group ids sorted (an object's local group id is its
    group's index there). Greedy and contiguous, charged per distinct group
    like the JAX package's _chunk_bounds (xmem2_tpu/ops/readout_kernel.py
    :130-155); a contiguous range keeps values[o0:o1] a view. G <= 8 and
    O <= 64: one chunk."""
    chunks, o0, groups = [], 0, set()
    for o, g in enumerate(group_ids):
        if o > o0 and (o - o0 == CHUNK_OBJECTS or (
                g not in groups and len(groups) == CHUNK_GROUPS)):
            chunks.append((o0, o, tuple(sorted(groups))))
            o0, groups = o, set()
        groups.add(g)
    if len(group_ids):
        chunks.append((o0, len(group_ids), tuple(sorted(groups))))
    return chunks


# ---------------------------------------------------------------------------
# K2: one-pass exact top-k with the k-th value's tie count
# ---------------------------------------------------------------------------

def _k2_inputs(sim: torch.Tensor, valid: Optional[torch.Tensor]):
    """Shared mode: sim [P, N], valid [G, N]. Grouped mode: sim [G, P, N],
    valid None (every slot valid). Returns (G, P, N)."""
    if valid is None:
        if sim.dim() != 3:
            raise ValueError('block_topk_candidates: without validity, sim '
                             'must be [G, P, N]')
        return sim.shape
    if sim.dim() != 2 or valid.dim() != 2 or valid.shape[1] != sim.shape[1]:
        raise ValueError('block_topk_candidates: sim [P, N] and valid [G, N] '
                         'disagree in shape')
    return (valid.shape[0],) + tuple(sim.shape)


def block_topk_candidates_plain(sim: torch.Tensor,
                                valid: Optional[torch.Tensor], k: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: per (group, row), the k largest valid values
    sorted descending with their multiplicities and -inf padding, and the
    count of valid slots equal to the k-th of them.

    sim [P, N] with valid [G, N] bool, or sim [G, P, N] with valid None ->
    (vals [G, P, k] f32, kcnt [G, P] int32)."""
    g, p, n = _k2_inputs(sim, valid)
    if valid is None:
        keep = torch.ones((g, 1, n), dtype=torch.bool, device=sim.device)
        masked = sim
    else:
        keep = valid[:, None, :]
        masked = torch.where(keep, sim[None], -torch.inf)     # [G, P, N]
    if n < k:
        masked = torch.nn.functional.pad(masked, (0, k - n), value=-torch.inf)
    vals = torch.topk(masked, k, dim=-1).values.contiguous()
    src = sim if valid is None else sim[None]
    kcnt = ((src == vals[..., -1:]) & keep).sum(-1, dtype=torch.int32)
    return vals, kcnt


def block_topk_candidates(sim: torch.Tensor, valid: Optional[torch.Tensor],
                          k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: one pass over a segment's similarity for all groups. Each row's
    exact top-k values (sorted descending, tie multiplicities, -inf
    padding) and the count of slots equal to its k-th value.

    sim [P, N] f32 with valid [G, N] bool, or sim [G, P, N] with valid None
    (the cross-segment merge) -> (vals [G, P, k] f32, kcnt [G, P] int32).
    k <= BN."""
    if not 0 < k <= BN:
        raise ValueError(f'block_topk_candidates: k={k} outside (0, {BN}]')
    if sim.device.type == 'cpu':
        return block_topk_candidates_plain(sim, valid, k)
    tensors = dict(sim=(sim, (torch.float32,)))
    if valid is not None:
        tensors['valid'] = (valid, (torch.bool,))
    _check_cuda('block_topk_candidates', sim.device, **tensors)
    g, p, n = _k2_inputs(sim, valid)
    vals = torch.empty((g, p, k), dtype=torch.float32, device=sim.device)
    kcnt = torch.empty((g, p), dtype=torch.int32, device=sim.device)
    fn = cuda_build.library('block_topk').block_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    # grouped mode: one group a CTA row; shared: chunks of plan_group_width
    width = 1 if valid is None else plan_group_width(g)
    rc = fn(
        _ptr(sim), ctypes.c_longlong(0 if valid is not None else p * n),
        None if valid is None else _ptr(valid), _ptr(vals), _ptr(kcnt),
        ctypes.c_int(p), ctypes.c_int(n), ctypes.c_int(g), ctypes.c_int(k),
        ctypes.c_int(width), _stream(sim))
    _raise_on(rc, 'block_topk_candidates')
    count('kernel.block_topk_candidates')
    return vals, kcnt


def block_topk_candidates_chunked(sim: torch.Tensor, valid: torch.Tensor,
                                  k: int,
                                  candidates=block_topk_candidates_plain):
    """K2's grid over group chunks in PyTorch (shared mode): one call of
    `candidates` per chunk of plan_group_width(G) groups, the results
    concatenated. Groups are independent, so it equals the unchunked
    call bit for bit."""
    g = valid.shape[0]
    w = plan_group_width(g)
    parts = [candidates(sim, valid[a:a + w], k) for a in range(0, g, w)]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([c for _, c in parts]))


# ---------------------------------------------------------------------------
# softmax stats: per-segment top-k -> (tau, rmax, 1/Z)
# ---------------------------------------------------------------------------

def _tie_count_dense(tau, sims, valids):
    """Slots equal to tau [G, P] over all segments, by dense passes over
    every [P, N] similarity: the sort path's count, and the closed form's
    oracle in the tests."""
    cnt = torch.zeros(tau.shape, dtype=torch.int64, device=tau.device)
    for sim, valid in zip(sims, valids):
        t = tau.to(sim.device)
        for gi in range(tau.shape[0]):
            eq = (sim == t[gi][:, None]) & valid[gi][None, :]
            cnt[gi] += torch.sum(eq, dim=-1).to(cnt.device)
    return cnt


def _tie_count_closed(tau, seg_vals, seg_kcnts):
    """The same count from K2's per-segment outputs, with no dense pass.

    tau is the global k-th value, so it is at least every segment's own
    k-th value v_s (else segment s alone would hold k values above tau).
    Where tau == v_s the segment's count is its k-th-value count; where
    tau > v_s every slot equal to tau is inside the segment's list, so the
    count is tau's multiplicity there. tau [G, P]; seg_vals [G, P, S, k]
    and seg_kcnts [G, P, S], segment s at index s."""
    t = tau[..., None]
    in_list = torch.sum(seg_vals == t[..., None], dim=-1)         # [G, P, S]
    return torch.sum(torch.where(seg_vals[..., -1] == t,
                                 seg_kcnts.long(), in_list), dim=-1)


def _stats_from_vals(vals, cnt_total):
    """(tau, rmax, 1/Z) [P, G] from the global top-k values [G, P, k] and the
    count of slots equal to the k-th value over all segments.

    Boundary ties: the streaming pass includes EVERY slot with sim >= tau,
    so when ties at the k-th value extend past the k values, Z from the k
    values alone under-counts. The tied slots outside the list add their
    mass to Z; without boundary ties the correction is exactly zero."""
    rmax = vals[..., 0]
    z = torch.sum(torch.exp(vals - rmax[..., None]), dim=-1)
    tau = vals[..., -1]
    cnt_in_k = torch.sum(vals == tau[..., None], dim=-1)
    # -inf tau/rmax only occur for under-full groups, where the correction
    # must vanish (and exp(-inf - -inf) would be nan)
    finite = torch.isfinite(tau) & torch.isfinite(rmax)
    tie_w = torch.where(finite, torch.exp(tau - rmax), torch.zeros_like(tau))
    z = z + (cnt_total - cnt_in_k).to(z.dtype) * tie_w
    return (tau.T.contiguous(), rmax.T.contiguous(), (1.0 / z).T.contiguous())


def _topk_stats_fused(sims: Sequence[torch.Tensor],
                      valids: Sequence[torch.Tensor], top_k: int,
                      candidates=block_topk_candidates):
    """tau / rmax / 1/Z, each [P, G], through K2: one launch per segment,
    one launch merging the segments' lists ([G, P, S*k] -> [G, P, k]), and
    the closed-form tie count.

    k counts each segment padded to the block width, as the JAX package does
    (its similarity is emitted at tile shape), so both packages clamp k
    alike. For k > BN/2 the JAX package's merge rounds stop shrinking and it
    takes its sort path; so does this one. `candidates` is K2's wrapper;
    chip_smoke.py passes its plain version to hold the kernel's stats
    against it on the card.

    The segments may lie on different devices (the shards of a sharded
    bank, parallel/sharded_readout.py): each segment's lists are computed on
    its own device and copied to the first segment's, where the merge and the
    stats are computed."""
    total_n = sum(_round_up(s.shape[-1], BN) for s in sims)
    k = min(top_k, total_n)
    if k > BN // 2:
        return _topk_stats(sims, valids, top_k)

    dev = sims[0].device
    per_seg = [candidates(sim, valid, k) for sim, valid in zip(sims, valids)]
    g, p = per_seg[0][1].shape
    cat = torch.cat([v.to(dev) for v, _ in per_seg], dim=-1)      # [G, P, S*k]
    vals = cat if len(per_seg) == 1 else candidates(cat, None, k)[0]
    cnt = _tie_count_closed(vals[..., -1], cat.view(g, p, len(per_seg), k),
                            torch.stack([c.to(dev) for _, c in per_seg],
                                        dim=-1))
    return _stats_from_vals(vals, cnt)


def _topk_stats(sims: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                top_k: int):
    """Sort-path stats (k > BN/2). Invalid and padding slots hold NEG_INF, as
    in the JAX package; each segment is padded to the block width."""
    g = valids[0].shape[0]
    total_n = sum(_round_up(s.shape[-1], BN) for s in sims)
    k = min(top_k, total_n)
    vals_g = []
    for gi in range(g):
        cands = []
        for sim, valid in zip(sims, valids):
            n = sim.shape[-1]
            simg = torch.where(valid[gi][None, :], sim,
                               torch.full_like(sim, NEG_INF))
            simg = torch.nn.functional.pad(simg, (0, _round_up(n, BN) - n),
                                           value=NEG_INF)
            cands.append(top_k_values(simg, min(k, simg.shape[-1])))
        merged = torch.cat([c.to(sims[0].device) for c in cands], dim=-1)
        vals_g.append(torch.topk(merged, k, dim=-1).values)
    vals = torch.stack(vals_g)
    return _stats_from_vals(vals, _tie_count_dense(vals[..., -1], sims,
                                                   valids))


# ---------------------------------------------------------------------------
# K1: streamed top-k readout and group-0 usage
# ---------------------------------------------------------------------------

def _weights(sim, valid_g, tau_g, rmax_g, invz_g):
    """w[p, n] = exp(sim - rmax) * invz where sim >= tau and the slot is
    valid, else an exact 0 (the gate sits inside the exp)."""
    keep = (sim >= tau_g[:, None]) & valid_g[None, :]
    w = torch.exp(sim - rmax_g[:, None]) * invz_g[:, None]
    return torch.where(keep, w, torch.zeros_like(w))


def topk_readout_plain(sim, values, valid, tau, rmax, invz,
                       group_ids: Tuple[int, ...]) -> torch.Tensor:
    """Plain version of the readout kernel: [O, P, Cv] float32."""
    aff = {g: _weights(sim, valid[g], tau[:, g], rmax[:, g], invz[:, g])
           for g in sorted(set(group_ids))}
    outs = []
    for o, g in enumerate(group_ids):
        a = aff[g]
        if values.dtype == torch.bfloat16:
            a = a.to(torch.bfloat16).float()   # bf16 affinity, f32 accumulate
        outs.append(a @ values[o].float())
    return torch.stack(outs)


def topk_usage_plain(sim, valid, tau, rmax, invz) -> torch.Tensor:
    """Plain version of the usage kernel: group-0 usage [N] float32."""
    return _weights(sim, valid[0], tau[:, 0], rmax[:, 0], invz[:, 0]).sum(0)


def _k1_table(plan, group_ids):
    """The kernel's chunk table as two ctypes int arrays: per chunk (o0,
    o1, number of groups, CHUNK_GROUPS global group ids, -1 padded), and
    per object of the chunks its local group id."""
    chunks, local = [], []
    for o0, o1, groups in plan:
        chunks += [o0, o1, len(groups)] + list(groups) \
            + [-1] * (CHUNK_GROUPS - len(groups))
        local += [groups.index(gid) for gid in group_ids[o0:o1]]
    return (ctypes.c_int * len(chunks))(*chunks), \
        (ctypes.c_int * len(local))(*local)


def topk_readout(sim: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
                 tau: torch.Tensor, rmax: torch.Tensor, invz: torch.Tensor,
                 group_ids: Tuple[int, ...]) -> torch.Tensor:
    """One segment's readout (K1): sim [P, N] f32, values [O, N, Cv] f32 or
    bf16, valid [G, N] bool, tau/rmax/invz [P, G] f32 -> [O, P, Cv] f32."""
    if sim.device.type == 'cpu':
        return topk_readout_plain(sim, values, valid, tau, rmax, invz,
                                  group_ids)
    f32 = (torch.float32,)
    _check_cuda('topk_readout', sim.device, sim=(sim, f32),
                values=(values, (torch.float32, torch.bfloat16)),
                valid=(valid, (torch.bool,)), tau=(tau, f32),
                rmax=(rmax, f32), invz=(invz, f32))
    p, n = sim.shape
    o, nv, cv = values.shape
    g = valid.shape[0]
    if nv != n or valid.shape[1] != n or len(group_ids) != o:
        raise ValueError('topk_readout: sim, values, valid and group_ids '
                         'disagree in shape')
    if tau.shape != (p, g) or rmax.shape != (p, g) or invz.shape != (p, g):
        raise ValueError('topk_readout: stats must be [P, G]')
    if max(group_ids) >= g or min(group_ids) < 0:
        raise ValueError('topk_readout: group id out of range')
    if cv % 4 or values.data_ptr() % 16:
        raise ValueError('topk_readout: the kernel reads values four '
                         'channels at a time: Cv must be a multiple of 4 and '
                         'values 16-byte aligned')
    out = torch.empty((o, p, cv), dtype=torch.float32, device=sim.device)
    fn = cuda_build.library('topk_readout').topk_readout_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p] \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    plan = plan_object_chunks(group_ids)
    for c0 in range(0, len(plan), K1_TABLE_CHUNKS):
        part = plan[c0:c0 + K1_TABLE_CHUNKS]
        chunks, local = _k1_table(part, group_ids)
        rc = fn(
            _ptr(sim), _ptr(values),
            ctypes.c_int(values.dtype == torch.bfloat16), _ptr(valid),
            _ptr(tau), _ptr(rmax), _ptr(invz), chunks, local,
            ctypes.c_int(len(part)), _ptr(out),
            ctypes.c_int(p), ctypes.c_int(n), ctypes.c_int(cv),
            ctypes.c_int(g), _stream(sim))
        _raise_on(rc, 'topk_readout')
        count('kernel.topk_readout')
    return out


def topk_readout_chunked(sim, values, valid, tau, rmax, invz,
                         group_ids: Tuple[int, ...],
                         readout=topk_readout_plain) -> torch.Tensor:
    """K1's grid over object chunks in PyTorch: for each range of
    plan_object_chunks, `readout` over the range's values (a view), its
    groups' validity rows and stats, and the local group ids, written into
    the range's output rows."""
    out = torch.empty((len(group_ids), sim.shape[0], values.shape[-1]),
                      dtype=torch.float32, device=sim.device)
    for o0, o1, groups in plan_object_chunks(group_ids):
        gg = list(groups)
        out[o0:o1] = readout(
            sim, values[o0:o1], valid[gg], tau[:, gg], rmax[:, gg],
            invz[:, gg], tuple(groups.index(gid) for gid in group_ids[o0:o1]))
    return out


def topk_usage(sim: torch.Tensor, valid: torch.Tensor, tau: torch.Tensor,
               rmax: torch.Tensor, invz: torch.Tensor) -> torch.Tensor:
    """One segment's group-0 usage (K1's reduction over queries):
    usage[n] = sum_p w_0[p, n] -> [N] f32."""
    if sim.device.type == 'cpu':
        return topk_usage_plain(sim, valid, tau, rmax, invz)
    f32 = (torch.float32,)
    _check_cuda('topk_usage', sim.device, sim=(sim, f32),
                valid=(valid, (torch.bool,)), tau=(tau, f32),
                rmax=(rmax, f32), invz=(invz, f32))
    p, n = sim.shape
    g = valid.shape[0]
    if valid.shape[1] != n or tau.shape != (p, g) or rmax.shape != (p, g) \
            or invz.shape != (p, g):
        raise ValueError('topk_usage: shapes disagree')
    usage = torch.empty((n,), dtype=torch.float32, device=sim.device)
    lib = cuda_build.library('topk_readout')
    lib.topk_usage_launch.restype = ctypes.c_int
    rc = lib.topk_usage_launch(_ptr(sim), _ptr(valid), _ptr(tau), _ptr(rmax),
                               _ptr(invz), _ptr(usage), ctypes.c_int(p),
                               ctypes.c_int(n), ctypes.c_int(g), _stream(sim))
    _raise_on(rc, 'topk_usage')
    count('kernel.topk_usage')
    return usage


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def fused_topk_readout_multi(
    segments: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor],
                             torch.Tensor, torch.Tensor]],
    qk: torch.Tensor, qe: Optional[torch.Tensor],
    group_ids: Tuple[int, ...], top_k: int,
    want_usage: Optional[Sequence[bool]] = None,
) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """Readout over several memory segments sharing one global top-k.

    segments: per store, (mk [N, Ck], ms [N] or None, values [O, N, Cv],
    valid [G, N] bool). Returns (readout [O, P, Cv] f32, [usage [N] f32 per
    segment]), equivalent to the dense path over the concatenation
    (reference memory_manager.py:61-190). want_usage: per segment, whether its
    usage is needed; the usage pass is skipped (None returned) otherwise.
    An empty segment takes no part; its usage is an empty tensor."""
    p = qk.shape[0]
    o, _, cv = segments[0][2].shape
    if want_usage is None:
        want_usage = [True] * len(segments)
    usages = [qk.new_zeros((0,)) if seg[0].shape[0] == 0 else None
              for seg in segments]
    live = [i for i, seg in enumerate(segments) if seg[0].shape[0] > 0]
    out = torch.zeros((o, p, cv), dtype=torch.float32, device=qk.device)
    if not live:            # no memory at all: nothing to read
        return out, usages
    sims = [get_similarity_padded(segments[i][0], segments[i][1], qk, qe, p,
                                  segments[i][0].shape[0]) for i in live]
    valids = [segments[i][3].contiguous() for i in live]
    tau, rmax, invz = _topk_stats_fused(sims, valids, top_k)

    for i, sim, valid in zip(live, sims, valids):
        out += topk_readout(sim, segments[i][2].contiguous(), valid, tau,
                            rmax, invz, tuple(group_ids))
        if want_usage[i]:
            usages[i] = topk_usage(sim, valid, tau, rmax, invz)
    return out, usages


def fused_topk_readout(mk, ms, qk, qe, values, valid,
                       group_ids: Tuple[int, ...], top_k: int):
    """Single-segment convenience wrapper: (readout [O, P, Cv] f32,
    usage [N] f32)."""
    readout, usages = fused_topk_readout_multi(
        [(mk, ms, values, valid)], qk, qe, group_ids, top_k)
    return readout, usages[0]
