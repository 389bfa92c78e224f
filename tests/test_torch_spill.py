"""Host spill of evicted long-term memory (`spill_long_term`): the port's
MemoryManager against xmem2_tpu's, driven in lock step through add_memory
with seeded tensors (no encoders). The archived rows, the eviction
survivors, and the rows revived by update_config (ranked by usage) and by
revive_from_archive(query_key) must be equal, to the float32 tolerance of
tests/test_torch_memory_manager.py; and the archive must hold exactly the
rows the port's own ST.evict_by_usage drops."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.test_torch_memory_manager import (
    ATOL, RTOL, Both, assert_store, frame_data, make_config)

# long-term memory holds 20 slots: 12 survive each eviction and a
# consolidation adds 8 prototypes, so every consolidation after the second
# evicts
SPILL = dict(max_long_term_elements=20, spill_long_term=True)


def run(cfg, n_frames=14, n_obj=2, seed=0):
    rng = np.random.default_rng(seed)
    both = Both(cfg)
    for _ in range(n_frames):
        key, shrink, sel, value = frame_data(rng, n_obj)
        both.add(key, shrink, value, list(range(1, n_obj + 1)), sel)
        qk, _, qe, _ = frame_data(rng, n_obj)
        both.match(qk, qe)
    return both, rng


def assert_archive(ta, ja):
    assert len(ta) == len(ja) > 0
    t, j = ta._consolidated(), ja._consolidated()
    for name in ('key', 'shrinkage', 'value', 'usage'):
        np.testing.assert_allclose(t[name], np.asarray(j[name], np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(t['val_valid'], j['val_valid'])


def test_archive_and_survivors_match_jax():
    both, _ = run(make_config(**SPILL))
    assert both.t.long_size == both.j.long_size
    assert_archive(both.t.archive, both.j.archive)
    assert_store(both.t.long, both.j.long, both.t.group_ids)


def test_archive_holds_what_eviction_drops(monkeypatch):
    """Every eviction splits the long-term rows into survivors and archived
    rows: together they are the rows before it, in order."""
    from xmem2_tpu_torch.memory import manager as MM
    from xmem2_tpu_torch.memory.manager import MemoryManager
    mm = MemoryManager(make_config(**SPILL), device='cpu')
    evict = MM.ST.evict_by_usage
    splits = []

    def checked(store, max_size):
        # the spill ran just before: the archive ends with what is dropped
        before = store.key[:store.size].clone()
        archived = len(mm.archive)
        evict(store, max_size)
        splits.append((before, store.key[:store.size].clone(), archived))
        return store

    monkeypatch.setattr(MM.ST, 'evict_by_usage', checked)
    rng = np.random.default_rng(1)
    t = torch.from_numpy
    for _ in range(14):
        key, shrink, sel, value = frame_data(rng, 1)
        mm.add_memory(t(key), t(shrink), t(value), [1], selection=t(sel))
        qk, _, qe, _ = frame_data(rng, 1)
        mm.match_memory(t(qk), t(qe))
    assert len(splits) >= 2
    archive = torch.from_numpy(mm.archive._consolidated()['key'])
    start = 0
    for before, after, end in splits:
        dropped = archive[start:end]
        start = end
        assert len(after) + len(dropped) == len(before)
        # survivors and dropped rows interleave back into `before`
        rows = {tuple(r.tolist()): k for k, r in enumerate(before)}
        idx_after = [rows[tuple(r.tolist())] for r in after]
        idx_drop = [rows[tuple(r.tolist())] for r in dropped]
        assert idx_after == sorted(idx_after)
        assert sorted(idx_after + idx_drop) == list(range(len(before)))


@pytest.mark.parametrize('ranking', ['usage', 'query'])
def test_revival_matches_jax(ranking, monkeypatch):
    """Raising max_long_term_elements through update_config grows the
    long-term store and revives the most used archived rows; with a query
    key, revive_from_archive ranks them by distance to its mean instead."""
    cfg = make_config(**SPILL)
    both, rng = run(cfg)
    archived = len(both.t.archive)
    if ranking == 'query':
        for m in (both.t, both.j):           # grow only; revive below
            monkeypatch.setattr(m, 'revive_from_archive', lambda *a, **k: 0)
    raised = dict(cfg, max_long_term_elements=36)
    both.j.update_config(dict(raised))
    both.t.update_config(dict(raised))
    if ranking == 'query':
        monkeypatch.undo()
        qk = frame_data(rng, 2)[0]
        n_j = both.j.revive_from_archive(jnp.asarray(np.moveaxis(qk, 1, -1)))
        n_t = both.t.revive_from_archive(torch.from_numpy(qk))
        assert n_t == n_j
    revived = archived - len(both.t.archive)
    assert 0 < revived < archived          # a choice among the archived rows
    assert both.t.long.capacity >= 36 + cfg['num_prototypes']
    assert both.t.long_size == both.j.long_size
    assert_archive(both.t.archive, both.j.archive)
    assert_store(both.t.long, both.j.long, both.t.group_ids)
    # the grown memory keeps working
    key, shrink, sel, value = frame_data(rng, 2)
    both.add(key, shrink, value, [1, 2], sel)
    qk, _, qe, _ = frame_data(rng, 2)
    t, j = both.match(qk, qe)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('spill', [False, True])
def test_raised_cap_grows_long_term_store(spill):
    """With or without spill, long-term memory grows past its old capacity
    once max_long_term_elements is raised on the live memory. With spill it
    stays in step with the JAX manager; without, the JAX manager does not
    grow its store (manager.py:337-343 grows it only when spilling), so only
    the port runs."""
    cfg = make_config(max_long_term_elements=20, spill_long_term=spill)
    both, rng = run(cfg)
    old_capacity = both.t.long.capacity
    raised = dict(cfg, max_long_term_elements=60)
    both.t.update_config(dict(raised))
    if spill:
        both.j.update_config(dict(raised))
    t = torch.from_numpy
    for _ in range(10):
        key, shrink, sel, value = frame_data(rng, 2)
        qk, _, qe, _ = frame_data(rng, 2)
        if spill:
            both.add(key, shrink, value, [1, 2], sel)
            out, ref = both.match(qk, qe)
            np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
        else:
            both.t.add_memory(t(key), t(shrink), t(value), [1, 2],
                              selection=t(sel))
            out = both.t.match_memory(t(qk), t(qe))
            assert bool(torch.isfinite(out).all())
    assert both.t.long_size > old_capacity
    if spill:
        assert both.t.long_size == both.j.long_size
        assert_store(both.t.long, both.j.long, both.t.group_ids)
