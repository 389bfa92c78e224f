"""The port's MemoryManager against xmem2_tpu's on identical inputs: append
and match, usage counters, working->long-term consolidation, long-term
eviction, several object groups, permanent memory add/update/remove, and the
bf16 value store. JAX runs its jnp readout path on the CPU; the port runs the
plain versions of its kernels. Inputs are NCHW numpy arrays; the JAX manager
takes them channels-last."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from xmem2_tpu.memory.manager import MemoryManager as JaxMM
from xmem2_tpu_torch.memory.manager import MemoryManager as TorchMM

CK, CV, H, W = 16, 8, 6, 8
# float32 readouts from the same memory in another summation order; after a
# consolidation the prototypes pass through one more softmax + product
RTOL = ATOL = 1e-4


def make_config(**over):
    cfg = {'hidden_dim': 8, 'top_k': 5, 'enable_long_term': True,
           'enable_long_term_count_usage': True, 'max_mid_term_frames': 4,
           'min_mid_term_frames': 2, 'num_prototypes': 8,
           'max_long_term_elements': 100, 'permanent_buffer_frames': 2,
           'value_store_dtype': 'float32'}
    cfg.update(over)
    return cfg


def frame_data(rng, n_obj):
    key = rng.standard_normal((1, CK, H, W)).astype(np.float32)
    shrink = (rng.standard_normal((1, 1, H, W)).astype(np.float32) ** 2) + 1
    sel = (1 / (1 + np.exp(-rng.standard_normal((1, CK, H, W))))).astype(
        np.float32)
    value = rng.standard_normal((1, n_obj, CV, H, W)).astype(np.float32)
    return key, shrink, sel, value


class Both:
    """The two managers driven in lock step."""

    def __init__(self, cfg):
        self.j = JaxMM(dict(cfg))
        self.t = TorchMM(dict(cfg), device='cpu')

    def add(self, key, shrink, value, objects, sel=None, permanent=False,
            ti=None):
        j = lambda x, src: jnp.asarray(np.moveaxis(x, src, -1))
        self.j.add_memory(j(key, 1), j(shrink, 1), j(value, 2), objects,
                          selection=None if sel is None else j(sel, 1),
                          permanent=permanent, ti=ti)
        t = torch.from_numpy
        self.t.add_memory(t(key), t(shrink), t(value), objects,
                          selection=None if sel is None else t(sel),
                          permanent=permanent, ti=ti)

    def match(self, qk, qe):
        j = lambda x: jnp.asarray(np.moveaxis(x, 1, -1))
        rj = np.moveaxis(np.asarray(self.j.match_memory(j(qk), j(qe)))[0],
                         -1, 1)                          # [O, CV, h, w]
        rt = self.t.match_memory(torch.from_numpy(qk),
                                 torch.from_numpy(qe))[0].numpy()
        return rt, rj


def run_sequence(cfg, n_frames, n_obj=2, seed=0, permanent_frames=()):
    rng = np.random.default_rng(seed)
    both = Both(cfg)
    objects = list(range(1, n_obj + 1))
    outs = []
    for ti in range(n_frames):
        key, shrink, sel, value = frame_data(rng, n_obj)
        both.add(key, shrink, value, objects, sel,
                 permanent=ti in permanent_frames, ti=ti)
        qk, _, qe, _ = frame_data(rng, n_obj)
        outs.append(both.match(qk, qe))
    return both, outs


def assert_outs(outs):
    for i, (t, j) in enumerate(outs):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                   err_msg=f'frame {i}')


def assert_store(ts, js, group_ids):
    n = ts.size
    assert n == int(js.size)
    for name in ('key', 'shrinkage', 'use_count', 'life_count'):
        np.testing.assert_allclose(getattr(ts, name)[:n].numpy(),
                                   np.asarray(getattr(js, name))[:n],
                                   rtol=RTOL, atol=1e-5, err_msg=name)
    valid = ts.val_valid[:, :n].numpy()
    np.testing.assert_array_equal(valid, np.asarray(js.val_valid)[:, :n])
    # values only where the object's group is valid: a prototype a group has
    # no data for holds an average over padding that is never read (the JAX
    # package averages over its whole capacity, the port over the occupied
    # candidates)
    for o, g in enumerate(group_ids):
        np.testing.assert_allclose(
            ts.value[o, :n][valid[g]].float().numpy(),
            np.asarray(js.value, np.float32)[o, :n][valid[g]],
            rtol=RTOL, atol=ATOL)


def test_working_memory_and_usage():
    both, outs = run_sequence(make_config(max_mid_term_frames=100), 4)
    assert_outs(outs)
    assert_store(both.t.temp, both.j.temp, both.t.group_ids)


def test_consolidation_into_long_term():
    both, outs = run_sequence(make_config(), 9)
    assert both.t.long_size > 0 and both.t.long_size == both.j.long_size
    assert_outs(outs)
    assert_store(both.t.long, both.j.long, both.t.group_ids)
    assert_store(both.t.temp, both.j.temp, both.t.group_ids)


def test_long_term_eviction():
    cfg = make_config(max_long_term_elements=20)
    both, outs = run_sequence(cfg, 14)
    assert both.t.long_size <= 20
    assert both.t.long_size == both.j.long_size
    assert_outs(outs)
    assert_store(both.t.long, both.j.long, both.t.group_ids)


@pytest.mark.parametrize('long_term', [False, True])
def test_late_object_group(long_term):
    """Object 2 appears after two frames: group 2 has no data for the older
    slots. With long-term memory on, both packages keep per-slot validity
    (documented deviation 1 from the reference)."""
    cfg = make_config(enable_long_term=long_term,
                      enable_long_term_count_usage=long_term)
    rng = np.random.default_rng(5)
    both = Both(cfg)
    for ti in range(2):
        key, shrink, sel, value = frame_data(rng, 1)
        both.add(key, shrink, value, [1], sel)
    outs = []
    for ti in range(2, 8):
        key, shrink, sel, value = frame_data(rng, 2)
        both.add(key, shrink, value, [1, 2], sel)
        qk, _, qe, _ = frame_data(rng, 2)
        outs.append(both.match(qk, qe))
    assert both.t.num_groups == 2 and both.t.group_ids == (0, 1)
    assert_outs(outs)
    if long_term:
        assert both.t.long_size > 0
        assert_store(both.t.long, both.j.long, both.t.group_ids)


def test_permanent_add_update_remove():
    cfg = make_config()
    rng = np.random.default_rng(3)
    both = Both(cfg)
    frames = [frame_data(rng, 2) for _ in range(3)]
    for ti, (key, shrink, sel, value) in enumerate(frames):
        both.add(key, shrink, value, [1, 2], sel, permanent=True, ti=ti)
    key, shrink, sel, value = frame_data(rng, 2)
    both.add(key, shrink, value, [1, 2], sel)
    qk, _, qe, _ = frame_data(rng, 2)
    outs = [both.match(qk, qe)]

    key, shrink, sel, value = frame_data(rng, 2)       # update frame 1
    j = lambda x, src: jnp.asarray(np.moveaxis(x, src, -1))
    both.j.update_permanent_memory(1, j(key, 1), j(shrink, 1), j(value, 2),
                                   j(sel, 1))
    t = torch.from_numpy
    both.t.update_permanent_memory(1, t(key), t(shrink), t(value), t(sel))
    outs.append(both.match(qk, qe))

    both.j.remove_from_permanent_memory(0)
    both.t.remove_from_permanent_memory(0)
    outs.append(both.match(qk, qe))
    assert both.t.frame_id_to_permanent_mem_idx == \
        both.j.frame_id_to_permanent_mem_idx == {1: 0, 2: 1}
    assert_outs(outs)
    assert_store(both.t.perm, both.j.perm, both.t.group_ids)


def test_bf16_value_store():
    """bf16 value banks (the autocast analog): within bf16 rounding of the
    f32 readout (8 mantissa bits: 2e-2), and the dtype survives
    consolidation."""
    cfg32 = make_config()
    cfg16 = make_config(value_store_dtype='bfloat16')
    _, outs32 = run_sequence(cfg32, 8)
    both16, outs16 = run_sequence(cfg16, 8)
    assert both16.t.temp.value.dtype == torch.bfloat16
    assert both16.t.long.value.dtype == torch.bfloat16
    for (t16, _), (t32, _) in zip(outs16, outs32):
        np.testing.assert_allclose(t16, t32, rtol=2e-2, atol=2e-2)
