"""The port's spans and counters (xmem2_tpu_torch/utils/profiling.py): a
span is the shared null context while no profiler records; inside
device_trace a tiny CPU run_on_video writes the span tree of the call, and
its counters follow the memory schedule worked out by hand below.

The video is tests/test_torch_run_on_video.py's: 16 frames of 64x96 (a
4x6 key grid, HW = 24 slots a frame), object 1 annotated on frame 0,
objects 1 and 2 on frame 7, both preloaded into permanent memory (48
slots). Here a memory frame comes every 3 frames and working memory holds
2 frames (48 slots) before it consolidates down to 1 frame plus 16
prototypes in long-term memory, which evicts its least used slots down to
8 (its cap of 24 less 16 prototypes) before each later consolidation.
"""

import json
from collections import Counter

import pytest
import torch

from tests.test_torch_run_on_video import (ANNOTATED, CONFIG, N_FRAMES,
                                           synth_params, write_video)
from xmem2_tpu_torch.utils import profiling as P

SCHEDULE_CONFIG = dict(CONFIG, mem_every=3, max_mid_term_frames=2,
                       min_mid_term_frames=1)
HW = 24
# the readouts of the run, in order: (frames read together, slots read =
# working + long-term + permanent). Frames 0 and 7 carry every object's
# mask and read nothing; frames 3, 6, 10 and 13 append to working memory
# after their readout, and 6, 10 and 13 then consolidate it; a run of
# plain frames before the next memory frame is one step_chunk (1-2, 4-5,
# 8-9, 11-12); 14 and 15 step alone (15 ends the video).
READOUTS = [(2, 0 + 0 + 48), (1, 0 + 0 + 48),          # 1-2, 3
            (2, 24 + 0 + 48), (1, 24 + 0 + 48),        # 4-5, 6
            (2, 24 + 16 + 48), (1, 24 + 16 + 48),      # 8-9, 10
            (2, 24 + 24 + 48), (1, 24 + 24 + 48),      # 11-12, 13
            (1, 24 + 24 + 48), (1, 24 + 24 + 48)]      # 14, 15
CHUNKS = [2, 2, 2, 2]

# each span's parent span: the innermost xmem. span around it
PARENTS = {
    'xmem.call': {None},
    'xmem.load': {'xmem.call'},
    'xmem.preload': {'xmem.call'},
    'xmem.loop': {'xmem.call'},
    'xmem.writers.drain': {'xmem.call'},
    'xmem.frame': {'xmem.loop'},
    'xmem.chunk': {'xmem.loop'},
    'xmem.reader.wait': {'xmem.loop'},
    'xmem.fetch.finish': {'xmem.loop'},
    'xmem.writers.start': {'xmem.fetch.finish'},
    'xmem.net.encode_key': {'xmem.frame', 'xmem.chunk', 'xmem.preload'},
    'xmem.net.encode_value': {'xmem.frame', 'xmem.preload'},
    'xmem.net.segment': {'xmem.frame', 'xmem.chunk'},
    'xmem.readout': {'xmem.frame', 'xmem.chunk'},
    'xmem.memory.append': {'xmem.frame', 'xmem.preload'},
    'xmem.memory.consolidate': {'xmem.frame'},
    'xmem.output.pack': {'xmem.frame', 'xmem.chunk'},
}


@pytest.fixture(scope='module')
def traced(tmp_path_factory):
    """One run_on_video call on the CPU inside device_trace: its spans
    (name, start, end, parent) and its counters."""
    root = tmp_path_factory.mktemp('traced')
    imgs, anns = write_video(root)
    ckpt = root / 'synth.pth'
    torch.save({k: torch.from_numpy(v) for k, v in synth_params().items()},
               ckpt)
    from xmem2_tpu_torch.inference.run_on_video import run_on_video
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with P.device_trace(str(root / 'trace'), 'cpu'):
            run_on_video(str(imgs), str(anns), str(root / 'out'),
                         frames_with_masks=ANNOTATED, print_progress=False,
                         save_overlay=False, device='cpu',
                         overwrite_config=dict(SCHEDULE_CONFIG,
                                               model=str(ckpt)))
    finally:
        torch.set_num_threads(threads)
    counts = P.counters()
    events = json.loads((root / 'trace' / 'trace.json').read_text())
    spans = sorted(((e['ts'], e['ts'] + e['dur'], e['name'])
                    for e in events['traceEvents']
                    if e.get('ph') == 'X'
                    and e.get('name', '').startswith('xmem.')),
                   key=lambda s: (s[0], -s[1]))
    tree, open_ = [], []
    for s, e, name in spans:
        while open_ and open_[-1][1] < e:
            open_.pop()
        tree.append((name, s, e, open_[-1][2] if open_ else None))
        open_.append((s, e, name))
    return tree, counts


def test_span_off_is_the_shared_null_context():
    """No profiler: every span is one shared null context, and a
    profiler started afterwards holds nothing of it."""
    from torch.profiler import ProfilerActivity, profile
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = P.annotate('xmem.a'), P.annotate('xmem.b', '1')
    assert a is b is P._NULL_SPAN
    assert P.call_span() is P._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with a:
            torch.ones(2).sum()
        assert P.annotate('xmem.c') is not P._NULL_SPAN
    assert not [e for e in prof.events() if e.name.startswith('xmem.a')]


def test_span_tree_of_a_call(traced):
    tree, counts = traced
    names = Counter(name for name, *_ in tree)
    assert names['xmem.call'] == 1
    assert set(names) == set(PARENTS)
    for name, _, _, parent in tree:
        assert parent in PARENTS[name], (name, parent)
    assert names['xmem.chunk'] == counts['chunks'] == len(CHUNKS)
    assert names['xmem.frame'] + counts['chunk_frames'] == N_FRAMES
    assert names['xmem.readout'] == len(READOUTS)
    assert names['xmem.memory.consolidate'] == 3
    # the two preloaded frames and four working-memory frames
    assert names['xmem.memory.append'] == counts['memory.appends'] == 6


def test_counters_follow_the_memory_schedule(traced):
    _, counts = traced
    assert counts['frames'] == N_FRAMES == sum(f for f, _ in READOUTS) + 2
    assert counts['chunk_frames'] == sum(CHUNKS)
    assert counts['readouts'] == len(READOUTS)
    assert counts['readout.query_rows'] == HW * sum(f for f, _ in READOUTS)
    assert counts['readout.slot_rows'] == \
        sum(HW * f * n for f, n in READOUTS) == 26496
    # consolidations after frames 6, 10 and 13; the last two evict 8 and
    # 16 long-term slots down to the cap less 16 prototypes
    assert counts['memory.consolidations'] == 3
    assert counts['memory.evicted_slots'] == 8 + 16
    assert counts['masks.enqueued'] == N_FRAMES
    assert counts['load.bytes'] > 0
    # on the CPU the readout runs the kernels' plain versions
    assert not any(k.startswith('kernel.') for k in counts)
    assert 'fetch.waits' not in counts


def test_counters_reset_when_a_call_starts():
    P.reset_counters()
    P.count('frames', 3)
    P.count('frames')
    assert P.counters() == {'frames': 4}
    P.call_span()
    assert P.counters() == {}
