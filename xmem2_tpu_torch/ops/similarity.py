"""Anisotropic-L2 memory affinity math: the plain PyTorch reference.

Counterpart of xmem2_tpu/ops/similarity.py (reference model/memory_util.py
:7-80), with the same query-major layouts: similarity [P, N] (P query pixels,
N memory slots), keys [N, Ck] / [P, Ck], values [N, Cv].

Precision: every product here runs in float32 without TF32 (see
config.pin_f32_precision). The JAX package keeps the similarity near f32 even
in its bf16 mode (its bf16x3 tier, similarity.py:78-86) because bf16 operands
flip top-k membership; the port simply computes it in f32 in both modes.

The streamed kernels with the same contract live in ops/readout_kernel.py.
"""

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # used instead of -inf so exp() gives an exact 0 without nan

_TOPK_BLOCK = 512  # level-1 block of the two-level exact top-k


def top_k_values(sim: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k values over the trailing axis, sorted descending.

    Two-level like the JAX package (block top-k, then top-k of the
    candidates); the result is the same multiset either way."""
    n = sim.shape[-1]
    k = min(k, n)
    bs = _TOPK_BLOCK
    if n <= 2 * bs or k >= bs:
        return torch.topk(sim, k, dim=-1).values
    lead = sim.shape[:-1]
    nb = n // bs
    blocks = sim[..., :nb * bs].reshape(lead + (nb, bs))
    cand = torch.topk(blocks, k, dim=-1).values.reshape(lead + (nb * k,))
    if n % bs:
        cand = torch.cat([cand, sim[..., nb * bs:]], dim=-1)
    return torch.topk(cand, k, dim=-1).values


def get_similarity(mk: torch.Tensor, ms: Optional[torch.Tensor],
                   qk: torch.Tensor, qe: Optional[torch.Tensor]) -> torch.Tensor:
    """Similarity [P, N] between memory keys mk [N, Ck] (shrinkage ms [N] or
    None) and query keys qk [P, Ck] (selection qe [P, Ck] or None).

    With selection:   sim[p,n] = -sum_c qe[p,c] * (mk[n,c] - qk[p,c])^2
    Without:          sim[p,n] = -||mk[n]||^2 + 2 mk[n].qk[p]
    Then scaled by ms[n] / sqrt(Ck).

    Leading batch dimensions broadcast (mk [B, N, Ck] with ms [B, N],
    qk/qe [B, P, Ck], or either side unbatched) -> [B, P, N]."""
    ck = mk.shape[-1]
    if qe is not None:
        a_sq = qe @ (mk * mk).mT                                  # [P, N]
        two_ab = 2.0 * ((qk * qe) @ mk.mT)
        b_sq = torch.sum(qe * qk * qk, dim=-1, keepdim=True)       # [P, 1]
        sim = -a_sq + two_ab - b_sq
    else:
        a_sq = torch.sum(mk * mk, dim=-1)                          # [N]
        two_ab = 2.0 * (qk @ mk.mT)
        sim = -a_sq[..., None, :] + two_ab
    if ms is not None:
        sim = sim * ms[..., None, :]
    return sim / math.sqrt(ck)


def get_similarity_padded(mk: torch.Tensor, ms: Optional[torch.Tensor],
                          qk: torch.Tensor, qe: Optional[torch.Tensor],
                          pp: int, nn: int) -> torch.Tensor:
    """get_similarity emitted at shape [pp, nn] through ONE augmented product:

        lhs = [qe, 2*qk*qe, b_sq]   [P, 2Ck+1]
        rhs = [-mk*mk, mk, -1]      [N, 2Ck+1]
        sim = (lhs @ rhs.T) * (ms / sqrt(Ck))

    (without selection: lhs = [2*qk, 1], rhs = [mk, -a_sq]). Padded rows and
    columns hold 0, not -inf: callers mask them through the validity planes.
    The port's kernels mask ragged edges themselves, so the readout calls
    this with pp = P and nn = N (no padding), keeping the single product."""
    ck = mk.shape[-1]
    p, n = qk.shape[0], mk.shape[0]
    scale = 1.0 / math.sqrt(ck)
    col = ms.float() * scale if ms is not None else torch.full(
        (n,), scale, dtype=torch.float32, device=mk.device)
    if qe is not None:
        b_sq = torch.sum(qe * qk * qk, dim=-1, keepdim=True)
        lhs = torch.cat([qe, 2.0 * qk * qe, b_sq], dim=-1)
        rhs = torch.cat([-mk * mk, mk, -torch.ones((n, 1), dtype=mk.dtype,
                                                  device=mk.device)], dim=-1)
    else:
        a_sq = torch.sum(mk * mk, dim=-1, keepdim=True)
        lhs = torch.cat([2.0 * qk, torch.ones((p, 1), dtype=qk.dtype,
                                              device=qk.device)], dim=-1)
        rhs = torch.cat([mk, -a_sq], dim=-1)
    if pp > p:
        lhs = torch.nn.functional.pad(lhs, (0, 0, 0, pp - p))
    if nn > n:
        rhs = torch.nn.functional.pad(rhs, (0, 0, 0, nn - n))
        col = torch.nn.functional.pad(col, (0, nn - n))
    return (lhs @ rhs.T) * col[None, :]


def _masked(sim: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return sim
    return torch.where(valid[None, :], sim, torch.full_like(sim, NEG_INF))


def _topk_weights(sim, top_k, valid):
    sim = _masked(sim, valid)
    top_k = min(top_k, sim.shape[-1])  # tiny memories degrade to full softmax
    vals, idx = torch.topk(sim, top_k, dim=-1)
    # max-subtraction: a no-op for softmax that keeps exp in range (the
    # reference skips it, model/memory_util.py:48)
    vals = vals - vals[..., :1]
    ex = torch.exp(torch.where(vals <= NEG_INF * 0.5,
                               torch.full_like(vals, -math.inf), vals))
    return ex / torch.sum(ex, dim=-1, keepdim=True), idx


def softmax_w_top(sim: torch.Tensor, top_k: int,
                  valid: Optional[torch.Tensor] = None,
                  return_usage: bool = False):
    """Exact top-k softmax over the trailing (memory) axis; invalid slots
    never receive mass. Returns the dense affinity [P, N] (zeros outside the
    per-row top-k) and, with return_usage, usage[n] = sum_p affinity[p, n]
    (reference do_softmax, model/memory_util.py:41-54)."""
    ex, idx = _topk_weights(sim, top_k, valid)
    affinity = torch.zeros_like(sim).scatter_(-1, idx, ex)
    if return_usage:
        return affinity, torch.sum(affinity, dim=0)
    return affinity


def topk_sparse_softmax(sim: torch.Tensor, top_k: int,
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax_w_top that stays sparse: (weights [P, k], indices [P, k])."""
    return _topk_weights(sim, top_k, valid)


def masked_softmax(sim: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full (not top-k) max-subtracted softmax over the trailing axis
    (reference do_softmax without top_k, model/memory_util.py:55-59)."""
    sim = _masked(sim, valid)
    m = torch.amax(sim, dim=-1, keepdim=True)
    ex = torch.exp(sim - m)
    return ex / torch.sum(ex, dim=-1, keepdim=True)


def readout(affinity: torch.Tensor, mv: torch.Tensor) -> torch.Tensor:
    """Value readout [P, N] @ [N, Cv] -> [P, Cv] in float32
    (reference memory_util.py:73-80)."""
    return affinity.float() @ mv.float()
