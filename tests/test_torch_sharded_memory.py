"""The port's memory-bank sharding (config `memory_shards`, parallel/) on the
CPU, every shard on `cpu`:

  - the sharded MemoryManager against the port's unsharded one, D in {2, 8}
    (mirroring tests/test_sharded_memory.py:104-160): add, match and usage,
    consolidation and eviction, permanent memory, capacities divisible by D,
    within 1e-5;
  - the sharded port against the JAX manager at memory_shards=8 on its
    8-device CPU mesh (tests/conftest.py), on tie-free draws, within 1e-5;
  - ties at the k-th value: the sharded port equals the unsharded port,
    while the JAX sharded readout's weights sum to more than 1;
  - sharded_topk_readout[_multi] and shard_memory_bank against the JAX
    functions on the mesh (mirroring tests/test_multichip.py:289-363), also
    with top_k above a shard's slot count;
  - run_on_video and the eval CLI with memory_shards 8 against the unsharded
    port and the root eval.py at --memory_shards 8 (mirroring
    tests/test_eval_cli.py:165-186).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from PIL import Image

from tests.test_torch_eval import MEMORY_FLAGS, _pngs, _root_module
from tests.test_torch_run_on_video import (  # noqa: F401
    ANNOTATED, CONFIG, one_torch_thread, synth_params, write_video)
from xmem2_tpu_torch.memory import sharded_store as SS
from xmem2_tpu_torch.memory.manager import MemoryManager
from xmem2_tpu_torch.ops import readout_kernel as RK
from xmem2_tpu_torch.parallel import sharded_readout as SR

CK, CV, H, W = 16, 8, 6, 8
TOL = 1e-5


def make_config(**over):
    cfg = {'hidden_dim': 8, 'top_k': 5, 'enable_long_term': True,
           'enable_long_term_count_usage': True, 'max_mid_term_frames': 4,
           'min_mid_term_frames': 2, 'num_prototypes': 8,
           'max_long_term_elements': 100, 'permanent_buffer_frames': 2,
           'value_store_dtype': 'float32', 'memory_shards': 0}
    cfg.update(over)
    return cfg


def frame_data(rng, n_obj):
    key = rng.standard_normal((1, CK, H, W)).astype(np.float32)
    shrink = (rng.standard_normal((1, 1, H, W)).astype(np.float32) ** 2) + 1
    sel = (1 / (1 + np.exp(-rng.standard_normal((1, CK, H, W))))).astype(
        np.float32)
    value = rng.standard_normal((1, n_obj, CV, H, W)).astype(np.float32)
    return key, shrink, sel, value


class ManagerSide:
    """NCHW numpy in, the port's or the JAX manager."""

    def __init__(self, config, jax_side=False):
        self.jax_side = jax_side
        if jax_side:
            from xmem2_tpu.memory.manager import MemoryManager as JaxMM
            self.mm = JaxMM(dict(config))
        else:
            self.mm = MemoryManager(dict(config), device='cpu')

    def _in(self, x, src):
        if self.jax_side:
            return jnp.asarray(np.moveaxis(x, src, -1))
        return torch.from_numpy(x)

    def add(self, key, shrink, value, objects, sel=None, permanent=False,
            ti=None):
        self.mm.add_memory(self._in(key, 1), self._in(shrink, 1),
                           self._in(value, 2), objects,
                           selection=None if sel is None else self._in(sel, 1),
                           permanent=permanent, ti=ti)

    def update_permanent(self, ti, key, shrink, value, sel):
        self.mm.update_permanent_memory(ti, self._in(key, 1),
                                        self._in(shrink, 1),
                                        self._in(value, 2), self._in(sel, 1))

    def match(self, qk, qe):
        out = self.mm.match_memory(self._in(qk, 1), self._in(qe, 1))
        if self.jax_side:
            return np.moveaxis(np.asarray(out)[0], -1, 1)
        return out[0].numpy()                               # [O, CV, h, w]


def run_pair(config, n_frames, shards, permanent_frames=(), seed=0):
    """The same add / match sequence through the port's unsharded and
    sharded managers. Returns both and their readouts."""
    rng = np.random.default_rng(seed)
    base = ManagerSide(make_config(**config))
    shrd = ManagerSide(make_config(memory_shards=shards, **config))
    objects = [1, 2]
    outs = []
    for ti in range(n_frames):
        key, shrink, sel, value = frame_data(rng, 2)
        for d in (base, shrd):
            d.add(key, shrink, value, objects, sel,
                  permanent=ti in permanent_frames, ti=ti)
        qk, _, qe, _ = frame_data(rng, 2)
        outs.append((base.match(qk, qe), shrd.match(qk, qe)))
    return base, shrd, outs


def assert_outs(outs, tol=TOL):
    for i, (a, b) in enumerate(outs):
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                   err_msg=f'frame {i}')


def assert_sharded(store, d):
    assert isinstance(store, SS.ShardedStore)
    assert len(store.shards) == d and store.capacity % d == 0
    assert sum(s.size for s in store.shards) == store.size


def gathered(store, name):
    """A sharded store's field over its occupied slots, in slot order."""
    idx = torch.arange(store.size)
    return SS.take(store, name, idx).numpy()


@pytest.mark.parametrize('shards', [2, 8])
def test_add_match_and_usage(shards):
    base, shrd, outs = run_pair(dict(max_mid_term_frames=100), 4, shards)
    assert_outs(outs)
    assert_sharded(shrd.mm.temp, shards)
    n = base.mm.temp_size
    assert shrd.mm.temp_size == n
    for name in ('use_count', 'life_count', 'key', 'shrinkage'):
        np.testing.assert_allclose(gathered(shrd.mm.temp, name),
                                   getattr(base.mm.temp, name)[:n].numpy(),
                                   rtol=TOL, atol=1e-6, err_msg=name)


@pytest.mark.parametrize('shards', [2, 8])
def test_consolidation_and_eviction(shards):
    """10 frames at max_mt 4 / min_mt 2 consolidate repeatedly; a long-term
    cap of 20 evicts (the survivors straddle shards)."""
    base, shrd, outs = run_pair(dict(max_long_term_elements=20), 10, shards)
    assert_outs(outs)
    assert base.mm.long_size > 0
    assert shrd.mm.long_size == base.mm.long_size
    assert_sharded(shrd.mm.long, shards)
    n = base.mm.long_size
    for name in ('key', 'use_count', 'val_valid'):
        np.testing.assert_allclose(
            gathered(shrd.mm.long, name),
            getattr(base.mm.long, name)[..., :n].numpy()
            if name == 'val_valid' else getattr(base.mm.long, name)[:n],
            rtol=TOL, atol=1e-6, err_msg=name)


@pytest.mark.parametrize('shards', [2, 8])
def test_permanent_memory_ops(shards):
    base, shrd, outs = run_pair(dict(max_mid_term_frames=100), 6, shards,
                                permanent_frames=(0, 3))
    assert_outs(outs)
    assert_sharded(shrd.mm.perm, shards)
    rng = np.random.default_rng(99)
    key, shrink, sel, value = frame_data(rng, 2)
    for d in (base, shrd):
        d.update_permanent(3, key, shrink, value, sel)
        d.mm.remove_from_permanent_memory(0)
    qk, _, qe, _ = frame_data(rng, 2)
    assert_outs([(base.match(qk, qe), shrd.match(qk, qe))])
    assert shrd.mm.frame_id_to_permanent_mem_idx == \
        base.mm.frame_id_to_permanent_mem_idx
    # the copy for a full re-propagation keeps the shards
    again = shrd.mm.copy_perm_mem_only()
    assert again.perm is shrd.mm.perm and again.sharded


@pytest.mark.parametrize('shards', [2, 8])
def test_capacity_divides_shards(shards):
    shrd = ManagerSide(make_config(memory_shards=shards, max_mid_term_frames=100))
    key, shrink, sel, value = frame_data(np.random.default_rng(0), 2)
    shrd.add(key, shrink, value, [1, 2], sel)
    for store in (shrd.mm.temp, shrd.mm.perm, shrd.mm.long):
        assert_sharded(store, shards)
        assert all(s.key.device.type == 'cpu' for s in store.shards)


def test_matches_jax_sharded_manager():
    """The port at memory_shards=8 against the JAX manager at memory_shards=8
    on the 8-device CPU mesh, random (tie-free) draws: add, match, usage."""
    if len(jax.devices()) < 8:
        pytest.skip('needs the 8-virtual-device CPU mesh')
    rng = np.random.default_rng(0)
    port = ManagerSide(make_config(memory_shards=8, max_mid_term_frames=100))
    ref = ManagerSide(make_config(memory_shards=8, max_mid_term_frames=100),
                 jax_side=True)
    outs = []
    for ti in range(4):
        key, shrink, sel, value = frame_data(rng, 2)
        for d in (port, ref):
            d.add(key, shrink, value, [1, 2], sel, ti=ti)
        qk, _, qe, _ = frame_data(rng, 2)
        outs.append((ref.match(qk, qe), port.match(qk, qe)))
    assert_outs(outs)
    n = port.mm.temp_size
    np.testing.assert_allclose(gathered(port.mm.temp, 'use_count'),
                               np.asarray(ref.mm.temp.use_count)[:n],
                               rtol=TOL, atol=1e-6)


def _bank(seed=0, n=4096, p=96, o=3, g=2, ck=16, cv=24, tie=0):
    """tests/test_multichip.py's case; with tie > 0 the first `tie` keys are
    one key repeated, with a small shrinkage, so every row's top-k ends in
    a tie longer than k."""
    rng = np.random.default_rng(seed)
    mk = rng.standard_normal((n, ck)).astype(np.float32)
    ms = ((rng.standard_normal((n,)) ** 2) + 1).astype(np.float32)
    if tie:
        mk[:tie] = mk[0]
        ms[:tie] = 1e-3
    qk = rng.standard_normal((p, ck)).astype(np.float32)
    qe = (1 / (1 + np.exp(-rng.standard_normal((p, ck))))).astype(np.float32)
    values = rng.standard_normal((o, n, cv)).astype(np.float32)
    valid = np.ones((g, n), bool)
    valid[:, -129:] = False
    if g > 1:
        valid[1, :n // 3] = False
    return mk, ms, qk, qe, values, valid


def _jax_sharded(mk, ms, qk, qe, values, valid, gids, top_k):
    from xmem2_tpu.parallel.sharded_readout import (
        shard_memory_bank, sharded_topk_readout)
    mesh = Mesh(np.array(jax.devices()[:8]), ('memory',))
    bank = shard_memory_bank(mesh, mk, ms, values, valid)
    out, usage = sharded_topk_readout(
        mesh, bank[0], bank[1], jnp.asarray(qk),
        None if qe is None else jnp.asarray(qe), bank[2], bank[3], gids,
        top_k)
    return np.asarray(out), np.asarray(usage)


def _port_sharded(mk, ms, qk, qe, values, valid, gids, top_k, shards=8):
    t = torch.from_numpy
    bank = SR.shard_memory_bank(t(mk), t(ms), t(values), t(valid),
                                ['cpu'] * shards)
    out, usages = SR.sharded_topk_readout(
        bank[0], bank[1], t(qk), None if qe is None else t(qe), bank[2],
        bank[3], gids, top_k)
    return out.numpy(), torch.cat(usages).numpy()


@pytest.mark.parametrize('variant', ['selection', 'no_selection',
                                     'top_k_above_shard'])
def test_sharded_readout_matches_jax(variant):
    """sharded_topk_readout over 8 shards against the JAX one on the mesh;
    'top_k_above_shard': 8 slots a shard and top_k = 30, where JAX clamps k
    per shard and K2 pads with -inf."""
    if len(jax.devices()) < 8:
        pytest.skip('needs the 8-virtual-device CPU mesh')
    if variant == 'selection':
        mk, ms, qk, qe, values, valid = _bank()
        gids = (0, 0, 1)
    elif variant == 'no_selection':
        mk, ms, qk, qe, values, valid = _bank(seed=3, o=1, g=1)
        qe, gids = None, (0,)
    else:
        mk, ms, qk, qe, values, valid = _bank(seed=5, n=64)
        valid[:, -5:] = False
        gids = (0, 0, 1)
    out, usage = _port_sharded(mk, ms, qk, qe, values, valid, gids, 30)
    ref, ref_usage = _jax_sharded(mk, ms, qk, qe, values, valid, gids, 30)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(usage, ref_usage, rtol=TOL, atol=1e-6)
    # and the unsharded port on the same bank
    t = torch.from_numpy
    one, one_usage = RK.fused_topk_readout(
        t(mk), t(ms), t(qk), None if qe is None else t(qe), t(values),
        t(valid), gids, 30)
    np.testing.assert_allclose(out, one.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(usage, one_usage.numpy(), rtol=TOL, atol=1e-6)


def test_sharded_readout_multi_matches_jax():
    """Three segments of different widths, 8 shards each, one global top-k:
    sharded_topk_readout_multi against the JAX one on the mesh and against
    the port's unsharded fused_topk_readout_multi."""
    if len(jax.devices()) < 8:
        pytest.skip('needs the 8-virtual-device CPU mesh')
    from xmem2_tpu.parallel.sharded_readout import (
        shard_memory_bank, sharded_topk_readout_multi)
    mesh = Mesh(np.array(jax.devices()[:8]), ('memory',))
    gids = (0, 1)
    banks = [_bank(seed=s, n=n, o=2) for s, n in ((0, 512), (1, 1024),
                                                   (2, 256))]
    qk, qe = banks[0][2], banks[0][3]
    t = torch.from_numpy
    port_segs, jax_segs, plain = [], [], []
    for mk, ms, _, _, values, valid in banks:
        b = SR.shard_memory_bank(t(mk), t(ms), t(values), t(valid),
                                 ['cpu'] * 8)
        port_segs.append(list(zip(*b)))
        jax_segs.append(shard_memory_bank(mesh, mk, ms, values, valid))
        plain.append((t(mk), t(ms), t(values), t(valid)))
    out, usages = SR.sharded_topk_readout_multi(port_segs, t(qk), t(qe),
                                                gids, 30)
    ref, ref_usages = sharded_topk_readout_multi(
        mesh, jax_segs, jnp.asarray(qk), jnp.asarray(qe), gids, 30)
    one, one_usages = RK.fused_topk_readout_multi(plain, t(qk), t(qe), gids,
                                                  30)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out.numpy(), one.numpy(), rtol=TOL, atol=TOL)
    for u, r, o in zip(usages, ref_usages, one_usages):
        np.testing.assert_allclose(torch.cat(u).numpy(), np.asarray(r),
                                   rtol=TOL, atol=1e-6)
        np.testing.assert_allclose(torch.cat(u).numpy(), o.numpy(),
                                   rtol=TOL, atol=1e-6)


def test_ties_sharded_equals_unsharded_jax_overweights():
    """300 slots hold one key (every row's k-th value is tied 300 times).
    The port's sharded readout equals its unsharded one: with all values 1
    the readout is the weights' sum, exactly 1. The JAX sharded readout
    keeps every tied slot but normalises by the k values alone: its weights
    sum to more than 1 (a standing departure of the reference)."""
    if len(jax.devices()) < 8:
        pytest.skip('needs the 8-virtual-device CPU mesh')
    mk, ms, qk, qe, values, valid = _bank(seed=7, n=1024, o=1, g=1,
                                          tie=300)
    values = np.ones_like(values)
    valid[:] = True
    gids = (0,)
    out, usage = _port_sharded(mk, ms, qk, qe, values, valid, gids, 30)
    t = torch.from_numpy
    one, one_usage = RK.fused_topk_readout(t(mk), t(ms), t(qk), t(qe),
                                           t(values), t(valid), gids, 30)
    sim = RK.get_similarity_padded(t(mk), t(ms), t(qk), t(qe), qk.shape[0],
                                   mk.shape[0])
    tau = RK._topk_stats_fused([sim], [t(valid)], 30)[0]
    assert int(((sim >= tau) & t(valid)).sum(1).min()) >= 300
    np.testing.assert_allclose(out, one.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(usage, one_usage.numpy(), rtol=TOL, atol=1e-6)
    np.testing.assert_allclose(out, 1.0, rtol=0, atol=1e-5)
    ref, _ = _jax_sharded(mk, ms, qk, qe, values, valid, gids, 30)
    assert float(ref.min()) > 1.5


def test_inference_core_takes_no_chunk_when_sharded():
    from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG
    from xmem2_tpu_torch.inference.core import InferenceCore
    from xmem2_tpu_torch.inference.net import XMemNet
    from xmem2_tpu_torch.models.network import XMem
    net = XMemNet(XMem(), device='cpu')
    core = InferenceCore(net, dict(VIDEO_INFERENCE_CONFIG, memory_shards=3),
                         device='cpu', shard_devices=['cpu'] * 3)
    assert core.memory.sharded and core.memory.shard_devices == \
        [torch.device('cpu')] * 3
    core.set_all_labels([1])
    image = np.zeros((32, 32, 3), np.float32)
    mask = np.zeros((1, 32, 32), np.float32)
    mask[0, 8:20, 8:20] = 1
    core.step(image, mask, [1])
    core.step(image)
    assert core.memory.work_mem_engaged and core.plain_run_length() == 0
    with pytest.raises(ValueError, match='shard devices'):
        MemoryManager(dict(VIDEO_INFERENCE_CONFIG, memory_shards=3),
                      device='cpu', shard_devices=['cpu'] * 2)


@pytest.fixture(scope='module')
def video(tmp_path_factory):
    """test_torch_run_on_video's 16-frame video and weights, and the same
    as a generic eval dataset with the root eval.py's masks at
    --memory_shards 8 (the JAX sharded readout on the 8-device mesh)."""
    root = tmp_path_factory.mktemp('sharded_video')
    imgs, anns = write_video(root)
    from xmem2_tpu.bridge.torch_params import convert_state_dict, save_params
    ckpt = root / 'synth.npz'
    save_params(convert_state_dict(synth_params()), str(ckpt))
    generic = root / 'generic'
    (generic / 'JPEGImages').mkdir(parents=True)
    (generic / 'Annotations').mkdir(parents=True)
    (generic / 'JPEGImages' / 'two').symlink_to(imgs)
    (generic / 'Annotations' / 'two').symlink_to(anns)
    if len(jax.devices()) >= 8:
        root_eval = _root_module('eval')
        mp = pytest.MonkeyPatch()
        mp.setattr(sys, 'argv', ['eval.py', '--dataset', 'G',
                                 '--generic_path', str(generic), '--model',
                                 str(ckpt), '--output', str(root / 'jax'),
                                 '--save_all', '--no_chunked',
                                 '--memory_shards', '8'] + MEMORY_FLAGS)
        try:
            root_eval.main()
        finally:
            mp.undo()
    return root, imgs, anns, ckpt


def test_run_on_video_sharded_equals_unsharded(video):
    """run_on_video(overwrite_config={'memory_shards': 8}, device='cpu')
    writes the masks of the unsharded run (the readouts agree within float
    summation order; masks within 0.1% of pixels)."""
    from xmem2_tpu_torch.inference.run_on_video import run_on_video
    root, imgs, anns, ckpt = video
    for tag, shards in (('one', 0), ('eight', 8)):
        run_on_video(str(imgs), str(anns), str(root / tag),
                     frames_with_masks=ANNOTATED, print_progress=False,
                     save_overlay=False, device='cpu',
                     overwrite_config=dict(CONFIG, model=str(ckpt),
                                           memory_shards=shards))
    a = sorted((root / 'one' / 'masks').glob('*.png'))
    b = sorted((root / 'eight' / 'masks').glob('*.png'))
    assert [p.name for p in a] == [p.name for p in b] and len(a) == 16
    for pa, pb in zip(a, b):
        x = np.asarray(Image.open(pa).convert('RGB'))
        y = np.asarray(Image.open(pb).convert('RGB'))
        assert float(np.any(x != y, axis=-1).mean()) <= 1e-3, pa.name


def test_eval_memory_shards_matches_jax(video, tmp_path):
    """python -m xmem2_tpu_torch.eval --memory_shards 8 --device cpu against
    the root eval.py --memory_shards 8 on the same data: palette masks equal
    up to 0.1% of pixels (argmax near-ties under another float32 summation
    order, as in tests/test_torch_eval.py)."""
    if len(jax.devices()) < 8:
        pytest.skip('needs the 8-virtual-device CPU mesh')
    from xmem2_tpu_torch import eval as port_eval
    root, _, _, ckpt = video
    stats = port_eval.main(['--dataset', 'G', '--generic_path',
                            str(root / 'generic'), '--model', str(ckpt),
                            '--output', str(tmp_path), '--save_all',
                            '--memory_shards', '8', '--device', 'cpu']
                           + MEMORY_FLAGS)
    assert stats['frames'] == 16
    ours, ref = _pngs(tmp_path), _pngs(root / 'jax')
    assert sorted(ours) == sorted(ref) and len(ref) == 16
    for name, b in ref.items():
        assert float((ours[name] != b).mean()) <= 1e-3, name
