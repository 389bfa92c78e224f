"""The readout kernels' plain versions and the orchestration around them
(xmem2_tpu_torch.ops.readout_kernel) on the CPU, against the JAX package.

  * K2 (block_topk_candidates: each row's top-k and its k-th value's tie
    count) against the top-k of the JAX Pallas per-block candidates run in
    interpret mode: selection only, so values are exactly equal; the stats
    it feeds (_topk_stats_fused) too, tau and rmax exactly, and the
    closed-form tie count against the dense count.
  * K1 (topk_readout / topk_usage) and fused_topk_readout_multi against the
    JAX jnp path (similarity + softmax_w_top + readout), NOT the JAX Pallas
    readout, which returns NaN at this commit (its readout_kernel.py:450
    reads unpadded values past their end). The cases are those of
    tests/test_readout_kernel.py.
  * Ties at the k-th value (duplicated keys): the oracle is the JAX
    _topk_stats output fed through the kernel's formula, in jnp below.

The CUDA kernels themselves run only on a card; chip_smoke.py holds them
against these plain versions there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from xmem2_tpu.ops import readout_kernel as JR
from xmem2_tpu.ops import similarity as JS
from xmem2_tpu_torch.ops import readout_kernel as TR
from xmem2_tpu_torch.ops.similarity import get_similarity_padded

# f32 sums in another order (XLA vs PyTorch CPU): rtol 1e-5
RTOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def make_case(seed, n, p, o, g, ck=16, cv=32, invalid_tail=0):
    rng = np.random.default_rng(seed)
    mk = rng.standard_normal((n, ck)).astype(np.float32)
    ms = (rng.standard_normal((n,)).astype(np.float32) ** 2) + 1
    qk = rng.standard_normal((p, ck)).astype(np.float32)
    qe = (1 / (1 + np.exp(-rng.standard_normal((p, ck))))).astype(np.float32)
    values = rng.standard_normal((o, n, cv)).astype(np.float32)
    valid = np.ones((g, n), bool)
    if invalid_tail:
        valid[:, -invalid_tail:] = False
    if g > 1:
        valid[1, :n // 3] = False  # a later group missing the oldest slots
    return mk, ms, qk, qe, values, valid


def dup_case(seed=3, n=600, p=90, o=1, cv=32):
    """Every (key, value) pair twice: fp ties at the k-th value."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n // 2, 16)).astype(np.float32)
    mk = np.concatenate([base, base])
    half = rng.standard_normal((n // 2,)).astype(np.float32) ** 2 + 1
    ms = np.concatenate([half, half])
    qk = rng.standard_normal((p, 16)).astype(np.float32)
    qe = (1 / (1 + np.exp(-rng.standard_normal((p, 16))))).astype(np.float32)
    vbase = rng.standard_normal((o, n // 2, cv)).astype(np.float32)
    values = np.concatenate([vbase, vbase], axis=1)
    return mk, ms, qk, qe, values, np.ones((1, n), bool)


def jnp_reference(mk, ms, qk, qe, values, valid, group_ids, top_k):
    """The JAX dense path: readout [O, P, Cv], group-0 usage [N]."""
    sim = JS.get_similarity(*map(jnp.asarray, (mk, ms, qk, qe)))
    affs = [JS.softmax_w_top(sim, top_k, valid=jnp.asarray(valid[g]))
            for g in range(valid.shape[0])]
    read = jnp.stack([JS.readout(affs[g], jnp.asarray(values[o]))
                      for o, g in enumerate(group_ids)])
    return np.asarray(read), np.asarray(jnp.sum(affs[0], axis=0))


def port_sim(mk, ms, qk, qe):
    return get_similarity_padded(t(mk), t(ms), t(qk), t(qe), qk.shape[0],
                                 mk.shape[0])


# ---------------------------------------------------------------------------
# K2 against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['ragged', 'groups', 'ties', 'n_below_k'])
def test_block_topk_candidates_match_pallas(case):
    """K2 = the top-k of the Pallas kernel's per-block candidates, bitwise,
    and its tie count = the dense count of the k-th value."""
    k = 30
    if case == 'ties':
        mk, ms, qk, qe, _, valid = dup_case(n=700)
    elif case == 'n_below_k':
        mk, ms, qk, qe, _, valid = make_case(1, 20, 40, 1, 1)
    else:
        g = 2 if case == 'groups' else 1
        mk, ms, qk, qe, _, valid = make_case(0, 1100, 70, 1, g,
                                             invalid_tail=37)
    sim = port_sim(mk, ms, qk, qe)
    vals, kcnt = TR.block_topk_candidates(sim, t(valid), k)
    cand = np.asarray(JR.block_topk_candidates(
        jnp.asarray(sim.numpy()), jnp.asarray(valid), k, interpret=True))
    want = -np.sort(-cand, axis=-1)[..., :k]
    assert vals.shape == want.shape and vals.dtype == torch.float32
    np.testing.assert_array_equal(vals.numpy(), want)
    s = sim.numpy()
    dense = ((s[None] == want[..., -1:]) & valid[:, None, :]).sum(-1)
    np.testing.assert_array_equal(kcnt.numpy(), dense)
    assert kcnt.dtype == torch.int32


def test_block_topk_candidates_grouped_merge():
    """Grouped mode (the cross-segment merge): sim [G, P, M], every slot
    valid, -inf entries included, against numpy's sort."""
    rng = np.random.default_rng(4)
    m = rng.standard_normal((2, 9, 90)).astype(np.float32)
    m[0, :, 50:] = -np.inf
    m[1, 3, 5:] = -np.inf
    vals, kcnt = TR.block_topk_candidates(t(m), None, 30)
    want = -np.sort(-m, axis=-1)[..., :30]
    np.testing.assert_array_equal(vals.numpy(), want)
    np.testing.assert_array_equal(kcnt.numpy(),
                                  (m == want[..., -1:]).sum(-1))


def _jax_padded(sims, valids):
    """The JAX package's production layout: sims padded with 0 columns to
    the block width, validity padded with False."""
    out_s, out_v = [], []
    for s, v in zip(sims, valids):
        pad = (-s.shape[1]) % TR.BN
        out_s.append(jnp.pad(jnp.asarray(s.numpy()), ((0, 0), (0, pad))))
        out_v.append(jnp.pad(jnp.asarray(v), ((0, 0), (0, pad))))
    return out_s, out_v


@pytest.mark.parametrize('case', ['segments', 'groups', 'ties', 'n_below_k'])
def test_topk_stats_match_pallas(case):
    top_k = 30
    if case == 'ties':
        mk, ms, qk, qe, _, valid = dup_case(n=900)
        cuts = (500, 900)
    elif case == 'n_below_k':
        mk, ms, qk, qe, _, valid = make_case(1, 20, 40, 1, 1)
        cuts = (20,)
    else:
        g = 2 if case == 'groups' else 1
        mk, ms, qk, qe, _, valid = make_case(7, 1300, 130, 1, g,
                                             invalid_tail=23)
        cuts = (700, 960, 1300)
    sims, valids, lo = [], [], 0
    for hi in cuts:
        sims.append(port_sim(mk[lo:hi], ms[lo:hi], qk, qe))
        valids.append(valid[:, lo:hi])
        lo = hi
    got = TR._topk_stats_fused(sims, [t(v) for v in valids], top_k)
    js, jv = _jax_padded(sims, valids)
    want = JR._topk_stats_fused(js, jv, top_k, interpret=True)
    for name, a, b in zip(('tau', 'rmax', 'invz'), got, want):
        b = np.asarray(b)
        if name == 'invz':
            # 1/Z sums exp() of the same values; XLA's and PyTorch's exp may
            # differ in the last ulp, so rtol 1e-6 (tau and rmax are pure
            # selection: exact)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def _split_case(case):
    """(sims, valids) of a case cut into segments, as the memory stores
    hold it."""
    if case == 'ties':
        mk, ms, qk, qe, _, valid = dup_case(n=900)
        cuts = (500, 900)
    else:
        mk, ms, qk, qe, _, valid = make_case(1, 20, 40, 1, 1)
        cuts = (20,)
    sims, valids, lo = [], [], 0
    for hi in cuts:
        sims.append(port_sim(mk[lo:hi], ms[lo:hi], qk, qe))
        valids.append(valid[:, lo:hi])
        lo = hi
    return sims, valids


@pytest.mark.parametrize('top_k', [30, 31])
@pytest.mark.parametrize('case', ['ties', 'n_below_k'])
def test_closed_form_tie_count(case, top_k):
    """The tie count from K2's per-segment outputs equals the dense count
    over every similarity, and the stats equal the JAX package's under ties
    (top_k 31 splits duplicated pairs at the k-th value)."""
    sims, valids = _split_case(case)
    tv = [t(v) for v in valids]
    total = sum(TR._round_up(s.shape[-1], TR.BN) for s in sims)
    k = min(top_k, total)
    per_seg = [TR.block_topk_candidates(s, v, k) for s, v in zip(sims, tv)]
    seg_vals = [v for v, _ in per_seg]
    merged = seg_vals[0] if len(seg_vals) == 1 else \
        TR.block_topk_candidates(torch.cat(seg_vals, -1), None, k)[0]
    tau = merged[..., -1]
    dense = TR._tie_count_dense(tau, sims, tv)
    closed = TR._tie_count_closed(tau, torch.stack(seg_vals, dim=2),
                                  torch.stack([c for _, c in per_seg], -1))
    np.testing.assert_array_equal(closed.numpy(), dense.numpy())
    if case == 'ties' and top_k == 31:
        in_k = (merged == tau[..., None]).sum(-1)
        assert bool((dense > in_k).any()), 'no boundary tie outside the k'

    got = TR._topk_stats_fused(sims, tv, top_k)
    js, jv = _jax_padded(sims, valids)
    want = JR._topk_stats_fused(js, jv, top_k, interpret=True)
    for name, a, b in zip(('tau', 'rmax', 'invz'), got, want):
        b = np.asarray(b)
        if name == 'invz':
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


# ---------------------------------------------------------------------------
# K1 and the whole readout against the jnp path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n,p,o,g,gids', [
    (700, 130, 1, 1, (0,)),
    (1200, 260, 2, 1, (0, 0)),
    (900, 100, 3, 2, (0, 0, 1)),
])
def test_fused_readout_matches_jnp(n, p, o, g, gids):
    case = make_case(0, n, p, o, g, invalid_tail=37)
    ref_read, ref_usage = jnp_reference(*case, gids, 30)
    got_read, got_usage = TR.fused_topk_readout(*map(t, case), gids, 30)
    np.testing.assert_allclose(got_read.numpy(), ref_read, rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(got_usage.numpy(), ref_usage, rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize('seg_ns,o,g,gids', [
    ((500, 300), 1, 1, (0,)),
    ((700, 260, 140), 2, 1, (0, 0)),
    ((600, 200, 300), 3, 2, (0, 0, 1)),
    ((40, 900), 2, 2, (0, 1)),     # one segment smaller than top_k
])
def test_multi_segment_matches_concat(seg_ns, o, g, gids):
    mk, ms, qk, qe, values, valid = make_case(7, sum(seg_ns), 130, o, g,
                                              invalid_tail=23)
    ref_read, ref_usage = jnp_reference(mk, ms, qk, qe, values, valid, gids,
                                        30)
    segments, off = [], 0
    for sn in seg_ns:
        sl = slice(off, off + sn)
        segments.append((t(mk[sl]), t(ms[sl]), t(values[:, sl]),
                         t(valid[:, sl])))
        off += sn
    got_read, usages = TR.fused_topk_readout_multi(segments, t(qk), t(qe),
                                                   gids, 30)
    np.testing.assert_allclose(got_read.numpy(), ref_read, rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(torch.cat(usages).numpy(), ref_usage,
                               rtol=RTOL, atol=1e-6)


def test_many_objects_at_full_value_width():
    """8 objects in 4 groups at Cv = 512, invalid tail."""
    gids = (0, 0, 0, 1, 1, 2, 3, 3)
    case = make_case(5, 400, 70, 8, 4, cv=512, invalid_tail=13)
    ref_read, ref_usage = jnp_reference(*case, gids, 30)
    got_read, got_usage = TR.fused_topk_readout(*map(t, case), gids, 30)
    np.testing.assert_allclose(got_read.numpy(), ref_read, rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(got_usage.numpy(), ref_usage, rtol=RTOL,
                               atol=1e-6)


def test_tiny_memory_degenerates_to_full_softmax():
    case = make_case(1, 20, 40, 1, 1)
    ref_read, ref_usage = jnp_reference(*case, (0,), 30)
    got_read, got_usage = TR.fused_topk_readout(*map(t, case), (0,), 30)
    np.testing.assert_allclose(got_read.numpy(), ref_read, rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(got_usage.numpy(), ref_usage, rtol=RTOL,
                               atol=1e-6)


def test_large_k_takes_the_sort_path():
    """top_k > BN/2: merge rounds would stop shrinking; the sort-path stats
    must still match the jnp path."""
    case = make_case(11, 900, 70, 1, 1)
    ref_read, ref_usage = jnp_reference(*case, (0,), 300)
    got_read, got_usage = TR.fused_topk_readout(*map(t, case), (0,), 300)
    np.testing.assert_allclose(got_read.numpy(), ref_read, rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(got_usage.numpy(), ref_usage, rtol=RTOL,
                               atol=1e-5)


class TestBoundaryTies:
    """Duplicated memory entries tie at the k-th similarity. The kernels
    include the whole tied set with exact normalisation, so the oracle is
    the JAX _topk_stats output put through the kernel's formula."""

    @staticmethod
    def oracle(sim, values, valid, top_k):
        tau, rmax, invz = JR._topk_stats([sim], [valid], top_k)
        keep = (sim >= tau[:, :1]) & valid[0][None, :]
        w = jnp.where(keep, jnp.exp(sim - rmax[:, :1]), 0.0) * invz[:, :1]
        read = jnp.matmul(w, values[0], precision='highest')
        return np.asarray(read)[None], np.asarray(jnp.sum(w, 0))

    @pytest.mark.parametrize('top_k', [30, 31])
    def test_matches_tie_oracle(self, top_k):
        mk, ms, qk, qe, values, valid = dup_case()
        sim = port_sim(mk, ms, qk, qe)
        ref_read, ref_usage = self.oracle(jnp.asarray(sim.numpy()),
                                          jnp.asarray(values),
                                          jnp.asarray(valid), top_k)
        got_read, got_usage = TR.fused_topk_readout(
            *map(t, (mk, ms, qk, qe, values, valid)), (0,), top_k)
        np.testing.assert_allclose(got_read.numpy(), ref_read, rtol=RTOL,
                                   atol=RTOL)
        np.testing.assert_allclose(got_usage.numpy(), ref_usage, rtol=RTOL,
                                   atol=1e-6)
        # every row's weights sum to exactly 1: total usage is P
        assert abs(float(got_usage.sum()) - qk.shape[0]) < 1e-3


def test_plain_kernel_versions_follow_the_formula():
    """topk_readout_plain / topk_usage_plain on given stats, f32 and bf16
    values, against the formula written out in jnp."""
    mk, ms, qk, qe, values, valid = make_case(9, 600, 50, 3, 2,
                                              invalid_tail=11)
    gids = (0, 1, 1)
    sim = port_sim(mk, ms, qk, qe)
    tau, rmax, invz = TR._topk_stats_fused([sim], [t(valid)], 30)
    js, jt, jm, jz = (jnp.asarray(x.numpy()) for x in (sim, tau, rmax, invz))

    def w(g):
        keep = (js >= jt[:, g:g + 1]) & jnp.asarray(valid[g])[None, :]
        return jnp.where(keep, jnp.exp(js - jm[:, g:g + 1]) * jz[:, g:g + 1],
                         0.0)

    for vdt in (torch.float32, torch.bfloat16):
        v = t(values).to(vdt)
        got = TR.topk_readout(sim, v, t(valid), tau, rmax, invz, gids)
        vv = jnp.asarray(v.float().numpy())
        for o, g in enumerate(gids):
            a = w(g)
            if vdt == torch.bfloat16:   # bf16 affinity, f32 accumulate
                a = a.astype(jnp.bfloat16).astype(jnp.float32)
            ref = np.asarray(jnp.matmul(a, vv[o], precision='highest'))
            np.testing.assert_allclose(got[o].numpy(), ref, rtol=RTOL,
                                       atol=RTOL)
    usage = TR.topk_usage(sim, t(valid), tau, rmax, invz)
    np.testing.assert_allclose(usage.numpy(), np.asarray(w(0).sum(0)),
                               rtol=RTOL, atol=1e-6)


def test_wrappers_reject_bad_input():
    sim = torch.zeros((4, 10))
    with pytest.raises(ValueError):
        TR.block_topk_candidates(sim, torch.ones((1, 10), dtype=torch.bool),
                                 0)
    with pytest.raises(ValueError):     # grouped mode needs [G, P, M]
        TR.block_topk_candidates(sim, None, 3)
    with pytest.raises(ValueError):     # validity width differs
        TR.block_topk_candidates(sim, torch.ones((1, 9), dtype=torch.bool),
                                 3)
