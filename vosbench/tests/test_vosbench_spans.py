"""The program's spans as the benchmark reads them (harness/spans.py) on a
trace written by hand, the readers' Trace of the same trace, and a CPU
rehearsal of readout_work_ratio.readout against the reference's record."""

import json
import types

import pytest

from vosbench.harness import common
from vosbench.harness import spans as S
from vosbench.harness import trace as T


def _x(cat, name, ts, dur, **args):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
            'tid': 7, 'args': args}


def _events():
    """A window of 1,500 us: a call with a load, a loop holding one frame
    whose segment launches a kernel, 2,500 short spans between the load and
    the loop, launches inside and outside every span, and a memset with no
    launch recorded."""
    ev = [_x('user_annotation', T.WINDOW, 0, 1500),
          _x('user_annotation', 'xmem.call', 0, 1000),
          _x('user_annotation', 'xmem.load', 10, 190),
          _x('user_annotation', 'xmem.loop', 300, 600),
          _x('user_annotation', 'xmem.frame', 310, 190),
          _x('user_annotation', 'vosbench.segment', 319, 82),
          _x('user_annotation', 'xmem.net.segment', 320, 80)]
    ev += [_x('user_annotation', 'xmem.output.pack', 200 + i * 0.016, 0.01)
           for i in range(2500)]
    for c, ts in ((1, 50), (2, 330), (3, 450), (4, 950), (5, 1250)):
        ev.append(_x('cuda_runtime', 'cudaLaunchKernel', ts, 2,
                     correlation=c))
    ev += [_x('gpu_memcpy', 'Memcpy HtoD (Pageable)', 100, 50,
              correlation=1),
           _x('kernel', 'conv', 340, 40, correlation=2),
           _x('kernel', 'add', 460, 10, correlation=3),
           _x('kernel', 'add', 960, 20, correlation=4),
           _x('kernel', 'add', 1300, 10, correlation=5),
           _x('gpu_memset', 'Memset', 1400, 5, correlation=6)]
    return ev


def test_spans_report_on_a_written_trace():
    rep = S.report(_events())
    assert rep['window_s'] == pytest.approx(1.5e-3)
    assert rep['busy_s'] == pytest.approx(135e-6)
    sp = rep['spans']
    self_s = {n: v['self_device_s'] for n, v in sp.items()}
    assert self_s == pytest.approx({
        'xmem.call': 20e-6, 'xmem.load': 50e-6, 'xmem.loop': 0.0,
        'xmem.frame': 10e-6, 'xmem.net.segment': 40e-6,
        'xmem.output.pack': 0.0, S.OUTSIDE: 10e-6, S.UNLAUNCHED: 5e-6})
    assert sp['xmem.output.pack']['count'] == 2500
    assert sp['xmem.call']['host_s'] == pytest.approx(1e-3)
    # idle inside the loop: 600 us less the conv's 40 and the add's 10
    assert sp['xmem.loop']['idle_s'] == pytest.approx(550e-6)
    assert rep['idle_s'] == pytest.approx(1365e-6)
    assert rep['idle_outside_loop_s'] == pytest.approx(815e-6)
    assert rep['outside_share'] == pytest.approx(15 / 135)
    # each gap named by the innermost span at its middle, however many
    # spans opened since the one that holds it (2,500 since xmem.call)
    assert [n for n, _ in rep['idle_gaps']] == [
        'xmem.loop', S.OUTSIDE, 'xmem.call', S.OUTSIDE, 'xmem.frame']
    assert [g for _, g in rep['idle_gaps']] == pytest.approx(
        [490e-6, 320e-6, 190e-6, 90e-6, 80e-6])
    # each operation by the span that launched it: the pageable copy in
    # the load, the adds in the frame, in the call and outside every span
    assert rep['launches'] == 4
    assert sorted(rep['span_ops'], key=lambda kv: kv[0]) == [
        [f'{S.UNLAUNCHED}:Memset', pytest.approx(5e-6)],
        [f'{S.OUTSIDE}:add', pytest.approx(10e-6)],
        ['xmem.call:add', pytest.approx(20e-6)],
        ['xmem.frame:add', pytest.approx(10e-6)],
        ['xmem.load:Memcpy HtoD (Pageable)', pytest.approx(50e-6)],
        ['xmem.net.segment:conv', pytest.approx(40e-6)]]
    assert rep['span_ops'][:2] == [
        ['xmem.load:Memcpy HtoD (Pageable)', pytest.approx(50e-6)],
        ['xmem.net.segment:conv', pytest.approx(40e-6)]]
    tr = T.Trace(spans=rep['spans'])
    assert tr.span_ms_per_frame(['xmem.load'], 2.0) == pytest.approx(0.025)
    assert tr.span_ms_per_frame(['xmem.net.', 'xmem.frame'], 2.0) == \
        pytest.approx(0.025)
    assert tr.span_ms_per_frame(['xmem.none'], 2.0) is None


def test_a_gap_outside_every_span_takes_the_host_operation():
    """Where no span is open at a gap's middle, the gap is named by the
    innermost host operation of the calling thread there."""
    ev = _events() + [_x('cpu_op', 'aten::item', 1100, 150),
                      _x('cpu_op', 'aten::_local_scalar_dense', 1120, 100)]
    rep = S.report(ev)
    assert [n for n, _ in rep['idle_gaps']] == [
        'xmem.loop', 'aten::_local_scalar_dense', 'xmem.call', S.OUTSIDE,
        'xmem.frame']


def test_the_readers_trace_of_the_same_trace(tmp_path):
    """What harness/trace.py gives the readers on this trace: the fields
    the existing metrics and the breakdown read, each worked out by hand."""
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': _events()}))
    tr = T.read(str(path), {'vosbench.segment': 'unused'})
    assert tr.window_s == pytest.approx(1.5e-3)
    assert tr.busy_s == pytest.approx(135e-6)
    assert tr.launches == 4
    assert tr.range_device_s == {'vosbench.segment': pytest.approx(40e-6)}
    assert tr.span_ms_per_frame(['xmem.'], 1.0) == pytest.approx(0.12)
    assert T.breakdown(tr)['device_ops'][:2] == [
        ['xmem.load:Memcpy HtoD (Pageable)', pytest.approx(50e-6)],
        ['xmem.net.segment:conv', pytest.approx(40e-6)]]
    assert [n for n, _ in T.breakdown(tr)['idle_gaps']] == [
        'xmem.loop', S.OUTSIDE, 'xmem.call', S.OUTSIDE, 'xmem.frame']


def test_without_spans_everything_is_outside():
    ev = [e for e in _events() if not e['name'].startswith('xmem.')]
    rep = S.report(ev)
    assert set(rep['spans']) == {S.OUTSIDE, S.UNLAUNCHED}
    assert rep['outside_share'] == pytest.approx(1.0)
    assert {n for n, _ in rep['idle_gaps']} == {S.OUTSIDE}


def test_readout_work_ratio_reads_100_against_the_reference(tmp_tmpdir):
    """A tiny video of the cell through run_on_video on the CPU, then the
    reference over the same video: the program read every slot the
    reference counts (24 frames, a memory frame every 3, one
    consolidation at least)."""
    from vosbench.drivers import video
    from vosbench.reference import vos
    from vosbench.tests.tiny import tiny_cell
    from xmem2_tpu_torch.inference.run_on_video import run_on_video
    from xmem2_tpu_torch.utils import profiling

    cell = tiny_cell('vos480-2obj')
    videos, ckpt = video.setup(cell, 2 ** 33 + 7, tmp_tmpdir, 'cpu')
    cfg = video._program_config(cell, ckpt)
    video._one_video(run_on_video, videos[0], tmp_tmpdir / 'out', cfg, 'cpu')
    counts = profiling.counters()
    record = vos.run_video(videos[0]['frames'], videos[0]['annotations'],
                           ckpt, cell.config['inference'], 'cpu', 'f32')
    assert record.consolidations >= 1
    assert counts['readouts'] < len(record.readouts)     # chunked frames
    assert counts['readout.query_rows'] == \
        sum(r.p for r in record.readouts)
    reader = common.Cell('vos480-2obj').readers()[
        'readout_work_ratio.readout']
    run = types.SimpleNamespace(record=record, frames=24.0)
    assert reader.read(None, run) == 100.0
    profiling.reset_counters()
    assert reader.read(None, run) is None
