"""CPU tests of the benchmark harness: its files found by name, what its
processes load, the work counts, the refusal without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from vosbench.harness import common
from vosbench.reference import work

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_every_piece_loads_by_name(cell):
    c = common.Cell(cell)
    assert hasattr(c.driver(), 'run')
    readers = c.readers()
    assert set(readers) == {m['name'] for m in c.per_layer}
    assert all(hasattr(r, 'read') for r in readers.values())
    assert c.end_to_end and c.per_layer
    assert {'setup_s'} <= {m['name'] for m in c.end_to_end}


def test_every_config_file_is_used_and_named():
    used = {w['config'] for w in BENCH['workloads']}
    for c in BENCH['configs']:
        assert c['name'] in used
        data = json.loads((ROOT / c['file']).read_text())
        assert data['name'] == c['name']
        assert data['reduced'] == c['reduced']


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, '-c', code + (
        '\nimport sys, json; print(json.dumps(sorted({m.split(".")[0] '
        'for m in sys.modules})))')], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program_or_jax():
    mods = _modules_after(
        'import sys; sys.path.insert(0, "."); '
        'import vosbench.reference.vos, vosbench.reference.net, '
        'vosbench.reference.weights, vosbench.reference.compare, '
        'vosbench.reference.work')
    assert not mods & {'jax', 'jaxlib', 'flax', 'xmem2_tpu',
                       'xmem2_tpu_torch'}


def test_a_run_loads_no_jax_compared_by_top_level_name():
    """The driver at a tiny size on the CPU, in a process of its own: the
    port is loaded (its name begins with the JAX package's), JAX and the
    JAX package are not; no helper process is left running."""
    mods = _modules_after(
        'import sys, time; sys.path.insert(0, "."); sys.path.insert(0, '
        '"vosbench/tests")\n'
        'import torch; torch.set_num_threads(4)\n'
        'from tiny import tiny_cell, args\n'
        'from vosbench.drivers import video\n'
        'res, checks = video.run(tiny_cell("vos480-2obj", 12), args(5), '
        '{"platform": "cpu"}, time.perf_counter(), dev="cpu")\n'
        'assert res["correct"], (res, checks)\n'
        'from multiprocessing import resource_tracker as rt\n'
        'from vosbench.harness import common\n'
        'common.stop_helper_processes()\n'
        'assert rt._resource_tracker._pid is None')
    assert 'xmem2_tpu_torch' in mods
    assert not mods & {'jax', 'jaxlib', 'flax', 'xmem2_tpu'}
    assert common.FORBIDDEN == ('jax', 'jaxlib', 'flax', 'xmem2_tpu')


def test_the_measured_command_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, 'vosbench/run.py', '--workload',
         BENCH['workloads'][0]['name'], '--seed', str(2 ** 33 + 1),
         '--seconds', '1', '--trace', '0'],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={'PATH': '/usr/bin:/bin', 'TMPDIR': str(tmp_path),
             'HOME': str(tmp_path), 'CUDA_VISIBLE_DEVICES': ''})
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'CUDA' in out.stderr


def test_readout_counts_match_hand_counts():
    # P = 2 query rows, N = 3 slots, Ck = 4, Cv = 5, 2 objects, top-k 3
    assert work.readout_flops(2, 3, 4, 5, 2, 3) == 4 * 2 * 3 * 4 + 2 * 2 * 2 \
        * 3 * 5
    # qk, qe 2x4 f32; keys 3x4 f32; shrinkage 3 f32; validity 1x3 bool;
    # values 2x3x5 bf16; output 2x2x5 f32
    assert work.readout_bytes(2, 3, 4, 5, 2, 1, 2) == \
        2 * 2 * 4 * 4 + 3 * 4 * 4 + 3 * 4 + 3 + 2 * 3 * 5 * 2 + 2 * 2 * 5 * 4
    # compute-bound at P = 1620, N = 17,820 (the similarity, f32 peak)
    f = work.readout_flops(1620, 17820, 64, 512, 2, 30)
    b = work.readout_bytes(1620, 17820, 64, 512, 2, 2, 2)
    assert work.least_seconds(f, b, 'float32') == f / 67e12


def test_network_flops_match_hand_counts():
    """The reference's counter at a small shape: one 3x3 convolution and
    one linear layer counted by hand."""
    import torch
    from vosbench.reference.net import FlopCounter, Precision
    c = FlopCounter()
    p = Precision('f32', c)
    p.conv(torch.zeros(1, 8, 6, 10, device='meta'),
           torch.zeros(4, 8, 3, 3, device='meta'), None, 1, 1)
    assert c.flops == 2 * (4 * 6 * 10) * (8 * 9)
    p.linear(torch.zeros(2, 16), torch.zeros(3, 16), None)
    assert c.flops == 2 * (4 * 6 * 10) * (8 * 9) + 2 * (2 * 3) * 16


def test_weight_spec_is_the_checkpoint_format():
    """The benchmark's list of XMem's tensors, made from the architecture,
    names and shapes every tensor the port's network holds."""
    from vosbench.reference.weights import xmem_spec
    from xmem2_tpu_torch.models.network import XMem
    port = {k: tuple(v.shape) for k, v in XMem().state_dict().items()}
    assert dict(xmem_spec()) == port


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_declared_ranges_resolve_to_the_program(cell):
    """Every range a cell's readers declare names a method of the port."""
    from vosbench.harness import trace
    declared = trace.declared_ranges(common.Cell(cell).readers().values())
    assert declared
    for target in declared.values():
        owner, attr = trace._resolve(target)
        assert callable(getattr(owner, attr))


def test_trace_read_and_readers_on_a_written_trace(tmp_path):
    """A Chrome trace written by hand: two kernels launched inside a
    range, one outside, a copy, and an idle gap; what Trace and the
    readers make of it."""
    import types
    from vosbench.harness import trace as T

    def x(cat, name, ts, dur, **args):
        return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
                'args': args}
    events = [
        x('user_annotation', T.WINDOW, 0, 1000),
        x('user_annotation', 'vosbench.segment', 100, 100),
        x('cuda_runtime', 'cudaLaunchKernel', 110, 5, correlation=1),
        x('cuda_runtime', 'cudaLaunchKernel', 150, 5, correlation=2),
        x('cuda_runtime', 'cudaLaunchKernel', 300, 5, correlation=3),
        x('kernel', 'conv', 200, 100, correlation=1),
        x('kernel', 'conv', 300, 50, correlation=2),
        x('kernel', 'add', 400, 100, correlation=3),
        x('gpu_memcpy', 'Memcpy HtoD', 800, 100, correlation=4)]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events}))
    tr = T.read(str(path), {'vosbench.segment': 'unused'})
    assert tr.window_s == 1e-3 and tr.launches == 3
    assert tr.busy_s == pytest.approx(350e-6)
    assert tr.range_device_s == {'vosbench.segment': pytest.approx(150e-6)}
    assert tr.op_s == pytest.approx({'conv': 150e-6, 'add': 100e-6,
                                     'Memcpy HtoD': 100e-6})
    assert tr.op_count == {'conv': 2, 'add': 1, 'Memcpy HtoD': 1}
    assert [g for _, g in tr.idle_gaps] == pytest.approx([300e-6, 50e-6])
    readers = common.Cell(BENCH['workloads'][0]['name']).readers()
    run = types.SimpleNamespace(frames=3.0)
    assert readers['launches_per_frame.infer'].read(tr, run) == 1.0
    assert readers['device_idle_share.infer'].read(tr, run) == \
        pytest.approx(65.0)
    assert readers['network_ms_per_frame.infer'].read(tr, run) == \
        pytest.approx(0.05)
    run = types.SimpleNamespace(frames=3.0, window_frames=300.0,
                                window_s=12.0)
    assert readers['frames_per_s.host'].read(tr, run) == 25.0
    assert readers['frames_per_s.host'].read(
        tr, types.SimpleNamespace(window_frames=0.0, window_s=0.0)) is None


class _Event:
    """A profiler event as device_busy reads it."""

    def __init__(self, kind, start, dur, cuda=True):
        import torch
        self._kind, self._s, self._d = kind, start, dur
        self._dev = torch.autograd.DeviceType.CUDA if cuda else \
            torch.autograd.DeviceType.CPU

    def device_type(self):
        return self._dev

    def activity_type(self):
        return self._kind

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_device_busy_counts_the_cards_operations_once():
    """Kernels, copies and memsets on the card, overlapping ones once;
    host events and annotations on the card's timeline left out."""
    from vosbench.harness.trace import device_busy
    events = [_Event('kernel', 0, 100), _Event('kernel', 50, 100),
              _Event('gpu_memcpy', 400, 100), _Event('gpu_memset', 500, 50),
              _Event('gpu_user_annotation', 0, 10_000),
              _Event('cuda_runtime', 0, 10_000, cuda=False)]
    busy, ops, kinds = device_busy(events)
    assert busy == pytest.approx(300e-9) and ops == 4
    assert kinds == {'kernel': 2, 'gpu_memcpy': 1, 'gpu_memset': 1,
                     'gpu_user_annotation': 1}
    assert device_busy(events[-2:])[0] is None
