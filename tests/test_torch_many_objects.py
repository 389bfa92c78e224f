"""Many objects and object groups in the port, on the CPU: past the 8 groups
and 64 objects that one CTA of a readout kernel handles.

  * fused_topk_readout_multi (the plain versions) against the JAX jnp path
    (xmem2_tpu/memory/manager.py:_match_kernel, fused=False) at 12 objects
    in 10 groups and 70 objects in 3 groups, within 1e-5;
  * the chunk planners' invariants, and the kernels' chunked decomposition
    (block_topk_candidates_chunked, topk_readout_chunked) driven with the
    plain versions against the unchunked plain versions: K2 bit-equal, K1
    within 1e-6; the chunk table the K1 launch reads, decoded;
  * the port's MemoryManager against the JAX one when every added frame
    brings new objects (ten groups; 70 objects in three), consolidation and
    permanent memory included;
  * run_on_video on a 24-frame 64x96 video whose 12 objects are first
    annotated on ten frames: ten object groups in both packages, the
    port's masks those of the JAX package (within the tolerance of
    tests/test_torch_run_on_video.py), and the same masks with the port's
    memory in 2 shards.

The CUDA kernels' chunk grids run only on a card: chip_smoke.py holds them
against the plain versions at these shapes there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

from tests.test_torch_memory_manager import (
    Both, assert_outs, assert_store, frame_data, make_config)
from tests.test_torch_run_on_video import (  # noqa: F401
    CONFIG, one_torch_thread, synth_params)
from xmem2_tpu.memory import manager as JM
from xmem2_tpu.memory.store import StoreBuffers
from xmem2_tpu_torch.ops import readout_kernel as RK

# (objects, groups): past the 8 groups, and past the 64 objects, of a CTA
SHAPES = [(12, 10), (70, 3)]


def many_group_ids(o: int, g: int):
    """Group ids of o objects in g groups as annotation makes them: each
    annotated frame brings a block of new objects (12 in 10: 3, then one
    each; 70 in 3: 30, 25, 15)."""
    if (o, g) == (12, 10):
        sizes = [3] + [1] * 9
    else:
        sizes = [30, 25, 15]
    assert sum(sizes) == o and len(sizes) == g
    return tuple(gi for gi, n in enumerate(sizes) for _ in range(n))


def _segments(seed, gids, seg_ns=(300, 520, 180), p=60, ck=16, cv=32):
    """[long | temp | perm] segments; group g holds data only from slot
    first[g] of the concatenation on (a later group lacks the older
    slots), group 0 from the start."""
    rng = np.random.default_rng(seed)
    o, g = len(gids), max(gids) + 1
    total = sum(seg_ns)
    first = [0] + [int(total * gi / (2 * g)) for gi in range(1, g)]
    qk = rng.standard_normal((p, ck)).astype(np.float32)
    qe = (1 / (1 + np.exp(-rng.standard_normal((p, ck))))).astype(np.float32)
    segs, at = [], 0
    for n in seg_ns:
        mk = rng.standard_normal((n, ck)).astype(np.float32)
        ms = (rng.standard_normal((n,)).astype(np.float32) ** 2) + 1
        values = rng.standard_normal((o, n, cv)).astype(np.float32)
        slot = at + np.arange(n)
        valid = np.stack([slot >= first[gi] for gi in range(g)])
        segs.append((mk, ms, values, valid))
        at += n
    return qk, qe, segs


def _jax_store(mk, ms, values, valid):
    n = mk.shape[0]
    return StoreBuffers(
        key=jnp.asarray(mk), shrinkage=jnp.asarray(ms),
        selection=jnp.zeros_like(jnp.asarray(mk)),
        value=jnp.asarray(values), val_valid=jnp.asarray(valid),
        use_count=jnp.zeros((n,), jnp.float32),
        life_count=jnp.ones((n,), jnp.float32),
        size=jnp.asarray(n, jnp.int32))


@pytest.mark.parametrize('o,g', SHAPES)
def test_fused_readout_matches_jax_jnp(o, g):
    """fused_topk_readout_multi over three segments (usage of long and
    temp) against the JAX manager's dense path: readout and usage within
    1e-5."""
    gids = many_group_ids(o, g)
    qk, qe, segs = _segments(o, gids)
    t = torch.from_numpy
    out, usages = RK.fused_topk_readout_multi(
        [(t(mk), t(ms), t(v), t(va)) for mk, ms, v, va in segs], t(qk), t(qe),
        gids, 30, want_usage=[True, True, False])
    long_, temp, perm = (_jax_store(*s) for s in segs)
    jout, jtemp, jlong = JM._match_kernel(
        temp, perm, long_, jnp.asarray(qk), jnp.asarray(qe), group_ids=gids,
        top_k=30, use_long=True, count_usage=True, count_long_usage=True,
        fused=False)
    assert out.shape == (o, qk.shape[0], segs[0][2].shape[-1])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for got, js, before in ((usages[0], jlong, long_), (usages[1], jtemp,
                                                        temp)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(js.use_count - before.use_count),
            rtol=1e-5, atol=1e-5)
    assert usages[2] is None


# ---------------------------------------------------------------------------
# the chunk planners and the kernels' chunked decomposition
# ---------------------------------------------------------------------------

PLAN_CASES = [
    (0, 1), (0, 0, 1, 1), tuple(range(8)), (0,) * 64, tuple(range(9)),
    (0,) * 65, many_group_ids(12, 10), many_group_ids(70, 3),
    tuple(range(20)), tuple(i // 3 for i in range(100)),
    (3, 1, 3, 0, 2, 2, 9, 8, 7, 6, 5, 4, 0, 11, 10, 1),
    tuple(np.random.default_rng(1).integers(0, 12, 150).tolist()),
]


@pytest.mark.parametrize('gids', PLAN_CASES)
def test_plan_object_chunks(gids):
    """Each chunk touches at most 8 groups and holds at most 64 objects;
    every object appears once, in order; the chunk's groups are the
    distinct groups of its objects; at most 8 groups and 64 objects make
    one chunk."""
    plan = RK.plan_object_chunks(gids)
    assert plan[0][0] == 0 and plan[-1][1] == len(gids)
    for (o0, o1, groups), nxt in zip(plan, plan[1:] + [None]):
        assert 0 < o1 - o0 <= RK.CHUNK_OBJECTS
        assert len(groups) <= RK.CHUNK_GROUPS
        assert groups == tuple(sorted(set(gids[o0:o1])))
        if nxt is not None:
            assert nxt[0] == o1
            # greedy: the next object did not fit
            grown = set(gids[o0:o1 + 1])
            assert o1 - o0 == RK.CHUNK_OBJECTS or \
                len(grown) > RK.CHUNK_GROUPS
    if len(set(gids)) <= 8 and len(gids) <= 64:
        assert plan == [(0, len(gids), tuple(sorted(set(gids))))]


@pytest.mark.parametrize('g', [1, 2, 7, 8, 9, 10, 16, 17, 30])
def test_plan_group_width(g):
    """K2's group chunks: ceil(G / 8) of them, each at most 8 wide,
    covering every group; G <= 8 is one chunk of G."""
    w = RK.plan_group_width(g)
    chunks = -(-g // w)
    assert 1 <= w <= RK.CHUNK_GROUPS and chunks == -(-g // RK.CHUNK_GROUPS)
    assert (g <= 8) == (w == g)


@pytest.mark.parametrize('gids', PLAN_CASES)
def test_k1_chunk_table(gids):
    """The table topk_readout hands its launch (csrc/topk_readout.cu
    topk_readout_launch) decodes to the plan: per chunk (o0, o1, the
    number of groups, the global ids, -1 padded), and per object its local
    group id, so that chunk-local group l of object o is gids[o]."""
    plan = RK.plan_object_chunks(gids)
    chunks, local = RK._k1_table(plan, gids)
    rows = np.asarray(list(chunks)).reshape(len(plan), 3 + RK.CHUNK_GROUPS)
    local = list(local)
    assert len(local) == len(gids)
    for (o0, o1, groups), row in zip(plan, rows):
        assert tuple(row[:3]) == (o0, o1, len(groups))
        assert tuple(row[3:3 + len(groups)]) == groups
        assert set(row[3 + len(groups):]) <= {-1}
        for o in range(o0, o1):
            assert groups[local[o]] == gids[o]


@pytest.mark.parametrize('vdt', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('o,g', SHAPES)
def test_chunked_decomposition_equals_plain(o, g, vdt):
    """The kernels' grids over chunks, each chunk one plain call: K2
    (values and k-th counts) bit-equal to the unchunked plain version, K1
    within 1e-6 of it, per segment and with the stats of all three."""
    gids = many_group_ids(o, g)
    qk, qe, segs = _segments(o + 1, gids)
    t = torch.from_numpy
    sims = [RK.get_similarity_padded(t(mk), t(ms), t(qk), t(qe),
                                     qk.shape[0], mk.shape[0])
            for mk, ms, _, _ in segs]
    valids = [t(va) for _, _, _, va in segs]
    for sim, valid in zip(sims, valids):
        want = RK.block_topk_candidates_plain(sim, valid, 30)
        got = RK.block_topk_candidates_chunked(sim, valid, 30)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    stats = RK._topk_stats_fused(sims, valids, 30)
    assert not any(bool(torch.isnan(s).any()) for s in stats)
    for sim, valid, (_, _, v, _) in zip(sims, valids, segs):
        values = t(v).to(vdt)
        want = RK.topk_readout_plain(sim, values, valid, *stats, gids)
        got = RK.topk_readout_chunked(sim, values, valid, *stats, gids)
        assert (got - want).abs().max().item() <= 1e-6
        assert want.abs().max().item() > 0


# ---------------------------------------------------------------------------
# the memory manager against JAX when frames bring new objects
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('sizes', [(3,) + (1,) * 9, (30, 25, 15)],
                         ids=['12_in_10', '70_in_3'])
def test_manager_new_groups_match_jax(sizes):
    """Every annotated frame (permanent memory) brings a new block of
    objects, which forms a new group; between them, working frames with
    every object so far (exhaustive masks); consolidation into long-term
    memory across the group changes. Readouts after every frame and the
    stores at the end against the JAX manager."""
    cfg = make_config(max_mid_term_frames=3, min_mid_term_frames=1,
                      num_prototypes=8, max_long_term_elements=60)
    rng = np.random.default_rng(11)
    both = Both(cfg)
    outs, n_obj = [], 0
    for gi, size in enumerate(sizes):
        n_obj += size
        objects = list(range(1, n_obj + 1))
        key, shrink, sel, value = frame_data(rng, n_obj)
        both.add(key, shrink, value, objects, sel, permanent=True, ti=2 * gi)
        for _ in range(1 if gi < len(sizes) - 1 else 3):
            key, shrink, sel, value = frame_data(rng, n_obj)
            both.add(key, shrink, value, objects, sel)
        qk, _, qe, _ = frame_data(rng, n_obj)
        outs.append(both.match(qk, qe))
    assert both.t.num_groups == both.j.num_groups == len(sizes)
    assert both.t.group_ids == tuple(both.j.group_ids)
    assert both.t.long_size > 0 and both.t.long_size == both.j.long_size
    assert_outs(outs)
    for name in ('perm', 'temp', 'long'):
        assert_store(getattr(both.t, name), getattr(both.j, name),
                     both.t.group_ids)


# ---------------------------------------------------------------------------
# run_on_video with objects first annotated on ten frames
# ---------------------------------------------------------------------------

H, W, N_FRAMES = 64, 96, 24
# objects 1-3 on frame 0, objects 4-12 first on frames 2, 4, ..., 18
FIRST = {o: 0 if o <= 3 else 2 * (o - 3) for o in range(1, 13)}
ANNOTATED = tuple(range(0, 20, 2))


def write_many_video(root):
    """12 textured ellipses on a 3 x 4 grid, each drawn from its first
    frame on, moving right; every annotated frame's palette mask carries
    every object present (exhaustive)."""
    rng = np.random.default_rng(2)
    imgs, anns = root / 'imgs', root / 'anns'
    imgs.mkdir()
    anns.mkdir()
    yy, xx = np.mgrid[0:H, 0:W]
    bg = rng.integers(0, 255, (H // 8, W // 8, 3)).astype(np.uint8)
    bg = np.asarray(Image.fromarray(bg).resize((W, H), Image.BILINEAR))
    colours = rng.integers(30, 230, (13, 3)).astype(np.uint8)
    palette = colours.reshape(-1).tolist() + [0] * (256 * 3 - 39)
    palette[:3] = [0, 0, 0]
    for t in range(N_FRAMES):
        label = np.zeros((H, W), np.uint8)
        for o in range(1, 13):
            if t < FIRST[o]:
                continue
            r, c = divmod(o - 1, 4)
            cy, cx = 11 + 21 * r, 12 + 24 * c + 0.3 * t
            label[((yy - cy) / 7) ** 2 + ((xx - cx) / 8) ** 2 < 1] = o
        frame = bg.copy()
        for o in range(1, 13):
            frame[label == o] = colours[o]
        noise = rng.integers(-12, 12, frame.shape)
        frame = np.clip(frame.astype(int) + noise, 0, 255).astype(np.uint8)
        Image.fromarray(frame).save(imgs / f'frame_{t:06d}.jpg', quality=95)
        if t in ANNOTATED:
            m = Image.fromarray(label, mode='P')
            m.putpalette(palette)
            m.save(anns / f'frame_{t:06d}.png')
    return imgs, anns


@pytest.fixture(scope='module')
def many_runs(tmp_path_factory):
    """run_on_video on the 12-object video: the JAX package's (its per-frame
    split path, as tests/test_torch_run_on_video.py runs it), and the
    port's unsharded and with the memory in 2 shards; each run's
    InferenceCore kept."""
    from xmem2_tpu.bridge.torch_params import convert_state_dict, save_params
    from xmem2_tpu.inference import run_on_video as JR
    from xmem2_tpu_torch.inference import run_on_video as TR

    root = tmp_path_factory.mktemp('many')
    imgs, anns = write_many_video(root)
    ckpt = root / 'synth.npz'
    save_params(convert_state_dict(synth_params()), str(ckpt))
    cores = {}
    mp = pytest.MonkeyPatch()
    for tag, module, extra in (
            ('jax', JR, dict(chunk_frames=False)),
            ('one', TR, dict(memory_shards=0)), ('two', TR,
                                                  dict(memory_shards=2))):
        load = module._load_main_objects

        def loaded(*a, _tag=tag, _load=load, **k):
            out = _load(*a, **k)
            cores[_tag] = out[1]
            return out
        mp.setattr(module, '_load_main_objects', loaded)
        if module is JR:
            mp.setenv('XMEM2_FAST_STEP', '0')
        try:
            module.run_on_video(
                str(imgs), str(anns), str(root / tag),
                frames_with_masks=ANNOTATED, print_progress=False,
                save_overlay=False, overwrite_config=dict(
                    CONFIG, model=str(ckpt), **extra),
                **({} if module is JR else {'device': 'cpu'}))
        finally:
            mp.undo()
    return root, cores


def _mask_files(d):
    return sorted((d / 'masks').glob('*.png'))


def test_run_on_video_ten_groups(many_runs):
    """Ten object groups form, one per annotated frame; every mask is
    written, in the video's palette, and the last frame shows most
    objects."""
    root, cores = many_runs
    mm = cores['one'].memory
    assert len(mm.obj_groups) == 10
    assert mm.group_ids == (0, 0, 0) + tuple(range(1, 10))
    files = _mask_files(root / 'one')
    assert len(files) == N_FRAMES
    last = np.asarray(Image.open(files[-1]).convert('RGB'))
    assert len({tuple(c) for c in last.reshape(-1, 3)}) >= 8


def _same_masks(dir_a, dir_b):
    """Equal masks up to 0.1% of a frame's pixels (argmax near-ties under
    another float32 summation order), as tests/test_torch_run_on_video.py
    holds the port to the JAX package."""
    a, b = _mask_files(dir_a), _mask_files(dir_b)
    assert [p.name for p in a] == [p.name for p in b] and len(a) == N_FRAMES
    for pa, pb in zip(a, b):
        x = np.asarray(Image.open(pa).convert('RGB'))
        y = np.asarray(Image.open(pb).convert('RGB'))
        assert float(np.any(x != y, axis=-1).mean()) <= 1e-3, pa.name


def test_run_on_video_matches_jax(many_runs):
    """Ten groups in both packages, the same group of every object, and the
    port's masks those of the JAX package."""
    root, cores = many_runs
    jm, tm = cores['jax'].memory, cores['one'].memory
    assert len(jm.obj_groups) == len(tm.obj_groups) == 10
    assert tuple(jm.group_ids) == tm.group_ids
    _same_masks(root / 'one', root / 'jax')


def test_run_on_video_sharded_ten_groups(many_runs):
    """memory_shards 2 writes the unsharded run's masks (within 0.1% of
    pixels: argmax near-ties under another summation order)."""
    root, cores = many_runs
    assert cores['two'].memory.sharded and \
        len(cores['two'].memory.obj_groups) == 10
    _same_masks(root / 'one', root / 'two')
