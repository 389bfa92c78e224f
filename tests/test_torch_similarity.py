"""xmem2_tpu_torch.ops.similarity (the port's plain reference for the memory
math) against xmem2_tpu.ops.similarity on the same seeded inputs, and against
the torch-captured golden ops_similarity.npz. float32 throughout: rtol about
1e-5 (the two libraries sum in other orders), and top-k membership equal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from xmem2_tpu.ops import similarity as JS
from xmem2_tpu_torch.ops import similarity as TS
from tests.conftest import load_golden

RTOL = 1e-5


def inputs(seed=0, n=700, p=90, ck=16, cv=24):
    rng = np.random.default_rng(seed)
    mk = rng.standard_normal((n, ck)).astype(np.float32)
    ms = (rng.standard_normal((n,)) ** 2 + 1).astype(np.float32)
    qk = rng.standard_normal((p, ck)).astype(np.float32)
    qe = (1 / (1 + np.exp(-rng.standard_normal((p, ck))))).astype(np.float32)
    mv = rng.standard_normal((n, cv)).astype(np.float32)
    valid = np.ones((n,), bool)
    valid[:n // 4] = False
    valid[-13:] = False
    return mk, ms, qk, qe, mv, valid


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize('use_ms,use_qe', [(True, True), (False, False),
                                           (False, True), (True, False)])
def test_get_similarity(use_ms, use_qe):
    mk, ms, qk, qe, *_ = inputs()
    ms_, qe_ = (ms if use_ms else None), (qe if use_qe else None)
    ref = JS.get_similarity(jnp.asarray(mk), None if ms_ is None else
                            jnp.asarray(ms_), jnp.asarray(qk),
                            None if qe_ is None else jnp.asarray(qe_))
    got = TS.get_similarity(t(mk), None if ms_ is None else t(ms_), t(qk),
                            None if qe_ is None else t(qe_))
    # the similarity is a difference of O(Ck) terms: relative error is
    # measured against its scale, so atol scales with max |sim|
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=RTOL * scale)


@pytest.mark.parametrize('use_qe', [True, False])
def test_get_similarity_padded(use_qe):
    mk, ms, qk, qe, *_ = inputs(1)
    qe_ = qe if use_qe else None
    pp, nn = 96, 1024
    ref = JS.get_similarity_padded(jnp.asarray(mk), jnp.asarray(ms),
                                   jnp.asarray(qk),
                                   None if qe_ is None else jnp.asarray(qe_),
                                   pp, nn)
    got = TS.get_similarity_padded(t(mk), t(ms), t(qk),
                                   None if qe_ is None else t(qe_), pp, nn)
    assert got.shape == (pp, nn)
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=RTOL * scale)
    # padding rows/columns are exactly 0 in both
    assert not got[90:].any() and not got[:, 700:].any()


@pytest.mark.parametrize('n,k', [(700, 30), (1500, 30), (3000, 40), (200, 30),
                                 (20, 30)])
def test_top_k_values(n, k):
    rng = np.random.default_rng(n)
    sim = rng.standard_normal((33, n)).astype(np.float32)
    ref = np.asarray(JS.top_k_values(jnp.asarray(sim), k))
    got = TS.top_k_values(t(sim), k).numpy()
    np.testing.assert_array_equal(got, ref)     # selection only: exact


@pytest.mark.parametrize('top_k', [30, 5, 2000])
def test_softmax_w_top(top_k):
    mk, ms, qk, qe, mv, valid = inputs(2)
    sim = np.asarray(JS.get_similarity(*map(jnp.asarray, (mk, ms, qk, qe))))
    ref, ref_u = JS.softmax_w_top(jnp.asarray(sim), top_k,
                                  valid=jnp.asarray(valid), return_usage=True)
    got, got_u = TS.softmax_w_top(t(sim), top_k, valid=t(valid),
                                  return_usage=True)
    ref = np.asarray(ref)
    # membership: XLA's CPU backend flushes subnormal floats to zero and
    # torch keeps them, so weights below 1e-30 count as outside the top-k
    np.testing.assert_array_equal(got.numpy() > 1e-30, ref > 1e-30)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(ref_u), rtol=RTOL,
                               atol=1e-6)


def test_topk_sparse_softmax():
    mk, ms, qk, qe, mv, valid = inputs(3)
    sim = np.asarray(JS.get_similarity(*map(jnp.asarray, (mk, ms, qk, qe))))
    rw, ri = JS.topk_sparse_softmax(jnp.asarray(sim), 30,
                                    valid=jnp.asarray(valid))
    gw, gi = TS.topk_sparse_softmax(t(sim), 30, valid=t(valid))
    np.testing.assert_array_equal(np.sort(gi.numpy(), -1),
                                  np.sort(np.asarray(ri), -1))
    np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=RTOL,
                               atol=1e-7)


def test_masked_softmax_and_readout():
    mk, ms, qk, qe, mv, valid = inputs(4)
    sim = np.asarray(JS.get_similarity(*map(jnp.asarray, (mk, ms, qk, qe))))
    ref = np.asarray(JS.masked_softmax(jnp.asarray(sim), jnp.asarray(valid)))
    got = TS.masked_softmax(t(sim), t(valid)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-7)
    ref_r = np.asarray(JS.readout(jnp.asarray(ref), jnp.asarray(mv)))
    got_r = TS.readout(t(ref), t(mv)).numpy()
    np.testing.assert_allclose(got_r, ref_r, rtol=RTOL, atol=RTOL)


class TestGolden:
    """tests/golden/ops_similarity.npz was captured from the reference torch
    implementation; layouts there are [1, C, N] and sim [1, N, P]. The
    tolerances are those of tests/test_ops.py."""

    @pytest.fixture(scope='class')
    def g(self):
        g = load_golden('ops_similarity')
        g['mk_'] = t(g['mk'][0].T)
        g['qk_'] = t(g['qk'][0].T)
        g['qe_'] = t(g['qe'][0].T)
        g['ms_'] = t(g['ms'][0, 0])
        return g

    def test_similarity(self, g):
        for ms, qe, key in ((g['ms_'], g['qe_'], 'sim_full'),
                            (None, None, 'sim_no_qe'),
                            (None, g['qe_'], 'sim_no_ms')):
            sim = TS.get_similarity(g['mk_'], ms, g['qk_'], qe)
            np.testing.assert_allclose(sim.numpy().T, g[key][0], rtol=2e-5,
                                       atol=2e-5, err_msg=key)

    def test_softmax_usage_readout(self, g):
        sim = t(g['sim_full'][0].T)
        aff, usage = TS.softmax_w_top(sim, int(g['top_k']), return_usage=True)
        np.testing.assert_allclose(aff.numpy().T, g['aff_topk'][0], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(usage.numpy(), g['usage'][0], rtol=1e-4,
                                   atol=1e-5)
        dense = TS.masked_softmax(sim)
        np.testing.assert_allclose(dense.numpy().T, g['aff_dense'][0],
                                   rtol=1e-5, atol=1e-6)
        out = TS.readout(t(g['aff_topk'][0].T), t(g['mv'][0].T))
        np.testing.assert_allclose(out.numpy().T, g['read'][0], rtol=1e-4,
                                   atol=1e-4)


def test_pad_and_aggregate_golden():
    """ops/tensor.py against ops_pad.npz / ops_aggregate.npz."""
    from xmem2_tpu_torch.ops.tensor import aggregate, pad_divide_by, unpad
    g = load_golden('ops_pad')
    padded, pad = pad_divide_by(t(g['img']), 16)
    np.testing.assert_array_equal(padded.numpy(), g['padded'])
    assert tuple(pad) == tuple(int(x) for x in g['pad'])
    np.testing.assert_array_equal(unpad(padded, pad).numpy(), g['img'])
    g = load_golden('ops_aggregate')
    logits, prob = aggregate(t(g['prob']), dim=0, return_logits=True)
    np.testing.assert_allclose(logits.numpy(), g['logits'], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(prob.numpy(), g['prob_out'], rtol=1e-5,
                               atol=1e-6)
