"""xmem2_tpu_torch.utils.profiling against xmem2_tpu.utils.profiling
(mirroring tests/test_profiling.py): the StageTimer report text on the same
stages and clock, the trace a no-op without a directory, and the trace file
written with an annotated range in it."""

import json
import time

from xmem2_tpu.utils import profiling as JP
from xmem2_tpu_torch.utils import profiling as TP


def test_stage_timer_report_matches_jax(monkeypatch):
    """Both timers fed one scripted clock: the same report, line for line."""
    def drive(timer_cls):
        ticks = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.001, 3.0, 3.0125])
        monkeypatch.setattr(time, 'perf_counter', lambda: next(ticks))
        t = timer_cls()
        for _ in range(3):
            with t.stage('encode'):
                pass
        with t.stage('match'):
            pass
        monkeypatch.undo()
        return t.report()

    ours, ref = drive(TP.StageTimer), drive(JP.StageTimer)
    assert ours == ref
    assert 'encode: 0.751s total, 250.33 ms/call over 3 calls' in ours
    assert 'match: 0.013s total' in ours and '1 calls' in ours


def test_device_trace_noop_without_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for d in (None, ''):
        with TP.device_trace(d):
            pass
    assert not list(tmp_path.iterdir())


def test_device_trace_writes_files(tmp_path):
    import torch
    with TP.device_trace(str(tmp_path / 'trace'), 'cpu'):
        with TP.annotate('matmul'):
            x = torch.ones((32, 32))
            (x @ x).sum()
    trace = json.loads((tmp_path / 'trace' / 'trace.json').read_text())
    assert any(e.get('name') == 'matmul' for e in trace['traceEvents'])
