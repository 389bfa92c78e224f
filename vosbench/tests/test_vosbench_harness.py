"""CPU tests of the benchmark harness: its files found by name, what its
processes load, the work counts, the refusal without a card, and a new
configuration joining by new files and appended entries alone."""

import json
import re
import shutil
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


def _missing_rehearsals() -> list:
    """The rehearsal files that the drivers some cell names lack:
    vosbench/tests/test_vosbench_<driver>.py, a tiny cut of the driver's
    cells on the CPU against its reference, with its own planted faults."""
    drivers = {common.Cell(c).traffic['driver'] for c in common.cells()}
    return sorted(f'test_vosbench_{d}.py' for d in drivers
                  if not (common.BENCH / 'tests'
                          / f'test_vosbench_{d}.py').exists())


def test_every_driver_has_its_rehearsals():
    assert _missing_rehearsals() == []


def _append_cell(root: Path, name: str, driver: str, rehearsed: bool):
    """Adds to the benchmark copy at root a configuration and a cell run by
    driver, by new files and entries appended to BENCHMARK.json alone, and
    the driver's rehearsal file where rehearsed."""
    bench = root / 'vosbench'
    entries = json.loads((root / 'BENCHMARK.json').read_text())
    entries['configs'].append({
        'name': f'{name}-net', 'source': f'https://example.org/{name}-net',
        'file': f'vosbench/configs/{name}-net.json', 'reduced': [],
        'why': f'a {driver} network'})
    entries['workloads'].append({
        'name': name, 'config': f'{name}-net', 'traffic': name, 'chips': 1,
        'why': f'a {driver} cell'})
    entries['per_layer'].append({
        'name': f'step_ms_per_frame.{name}', 'unit': 'ms/frame',
        'better': 'lower', 'source': 'program_span',
        'layer': f'{driver} step', 'moves': 'device_ms_per_frame',
        'workloads': [name]})
    (root / 'BENCHMARK.json').write_text(json.dumps(entries))
    (bench / 'configs' / f'{name}-net.json').write_text(json.dumps(
        {'name': f'{name}-net', 'reduced': []}))
    (bench / 'workloads' / f'{name}.json').write_text(json.dumps(
        {'config': f'{name}-net', 'driver': driver}))
    (bench / 'drivers' / f'{driver}.py').write_text(
        'def run(cell, args, device, process_start):\n'
        '    return {}, {}\n')
    (bench / 'metrics' / f'step_ms_per_frame.{name}.py').write_text(
        f'SPANS = ("{driver}.step",)\n\n\n'
        'def read(trace, run):\n'
        '    return trace.span_ms_per_frame(SPANS, run.frames)\n')
    if rehearsed:
        (bench / 'tests' / f'test_vosbench_{driver}.py').write_text('')


@pytest.mark.parametrize('present', [(), ('other',)],
                         ids=['video-only', 'with-another-driver'])
def test_a_second_driver_joins_by_new_files_alone(tmp_path, monkeypatch,
                                                  present):
    """A copy of the benchmark, holding besides its own cells one of each
    driver in present (with its rehearsals), to which a cell of a stub
    driver is added by new files and entries appended to BENCHMARK.json:
    its driver and readers load by name, it reports both end-to-end
    metrics, the video driver's rehearsals leave it out as they leave out
    the others, and the rehearsal guard asks for its file until it is
    there."""
    from vosbench.harness.trace import Trace
    video_cells = common.cells('video')
    shutil.copytree(common.BENCH, tmp_path / 'vosbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(BENCH))
    monkeypatch.setattr(common, 'ROOT', tmp_path)
    monkeypatch.setattr(common, 'BENCH', tmp_path / 'vosbench')
    for driver in present:
        _append_cell(tmp_path, f'{driver}-cell', driver, rehearsed=True)
    before = common.cells()
    assert common.cells('video') == video_cells
    assert _missing_rehearsals() == []

    _append_cell(tmp_path, 'stub-cell', 'stub', rehearsed=False)
    cell = common.Cell('stub-cell')
    assert hasattr(cell.driver(), 'run')
    assert [m['name'] for m in cell.end_to_end] == ['device_ms_per_frame',
                                                    'setup_s']
    readers = cell.readers()
    assert set(readers) == {'step_ms_per_frame.stub-cell'}
    tr = Trace(spans={'stub.step': {'self_device_s': 3e-3}})
    run = type('Run', (), {'frames': 2.0})
    assert readers['step_ms_per_frame.stub-cell'].read(tr, run) == \
        pytest.approx(1.5)
    assert readers['step_ms_per_frame.stub-cell'].read(Trace(), run) is None
    assert common.cells() == before + ['stub-cell']
    assert common.cells('video') == video_cells
    assert common.cells('stub') == ['stub-cell']
    for driver in present:
        assert common.cells(driver) == [f'{driver}-cell']
    assert _missing_rehearsals() == ['test_vosbench_stub.py']
    (tmp_path / 'vosbench' / 'tests' / 'test_vosbench_stub.py').write_text('')
    assert _missing_rehearsals() == []


def test_a_cell_of_an_unknown_configuration_is_refused(tmp_path,
                                                       monkeypatch):
    entries = dict(BENCH)
    entries['configs'] = []
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(entries))
    monkeypatch.setattr(common, 'ROOT', tmp_path)
    with pytest.raises(common.Refused, match='no configuration'):
        common.Cell(BENCH['workloads'][0]['name'])


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


def _opened_spans() -> set:
    """The span names that the port opens (annotate('...') in its
    sources)."""
    return {n for f in (ROOT / 'xmem2_tpu_torch').rglob('*.py')
            for n in re.findall(r"""annotate\(\s*['"]([^'"]+)['"]""",
                                f.read_text())}


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_declared_ranges_resolve_to_the_program(cell):
    """Every range a cell's readers declare names a method of the port,
    every span they read (SPANS: names, or prefixes ending in '.') is one
    the port opens, and the cell's readers declare one at least."""
    from vosbench.harness import spans, trace
    readers = common.Cell(cell).readers().values()
    declared = trace.declared_ranges(readers)
    read = {n for r in readers for n in getattr(r, 'SPANS', ())}
    assert declared or read
    for target in declared.values():
        owner, attr = trace._resolve(target)
        assert callable(getattr(owner, attr))
    opened = _opened_spans()
    assert 'xmem.load' in opened and 'xmem.memory.append' in opened
    for name in read:
        assert any(spans.matches(o, [name]) for o in opened), name


def test_trace_read_and_readers_on_a_written_trace(tmp_path):
    """A Chrome trace written by hand: two kernels launched inside a
    range, one outside, a copy, and an idle gap, under the program's spans
    (a call; in it a load and a memory append, each launching a kernel of
    the range, and a preload launching the third); what Trace and the
    readers make of it."""
    import types
    from vosbench.harness import spans as S
    from vosbench.harness import trace as T

    def x(cat, name, ts, dur, **args):
        return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
                'args': args}
    events = [
        x('user_annotation', T.WINDOW, 0, 1000),
        x('user_annotation', 'xmem.call', 50, 900),
        x('user_annotation', 'xmem.load', 105, 25),
        x('user_annotation', 'xmem.memory.append', 140, 20),
        x('user_annotation', 'xmem.preload', 295, 15),
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
    assert not path.exists()
    assert tr.window_s == 1e-3 and tr.launches == 3
    assert tr.busy_s == pytest.approx(350e-6)
    assert tr.range_device_s == {'vosbench.segment': pytest.approx(150e-6)}
    assert [g for _, g in tr.idle_gaps] == pytest.approx([300e-6, 50e-6])
    assert [n for n, _ in tr.idle_gaps] == ['xmem.call', 'xmem.call']
    # the program's spans: report()'s own reading of the same events
    rep = S.report(events, ranges=['vosbench.segment'])
    assert tr.spans == rep['spans']
    assert tr.range_device_s == rep['range_device_s']
    assert {n: v['self_device_s'] for n, v in tr.spans.items()} == \
        pytest.approx({'xmem.call': 0.0, 'xmem.load': 100e-6,
                       'xmem.memory.append': 50e-6, 'xmem.preload': 100e-6,
                       S.UNLAUNCHED: 100e-6})
    assert T.breakdown(tr)['device_ops'] == [
        ['xmem.load:conv', pytest.approx(100e-6)],
        ['xmem.preload:add', pytest.approx(100e-6)],
        [f'{S.UNLAUNCHED}:Memcpy HtoD', pytest.approx(100e-6)],
        ['xmem.memory.append:conv', pytest.approx(50e-6)]]
    readers = common.Cell(BENCH['workloads'][0]['name']).readers()
    run = types.SimpleNamespace(frames=3.0)
    # (100 + 100) us over 3 frames; 50 us over 3 frames
    assert readers['load_ms_per_frame.call'].read(tr, run) == \
        pytest.approx(0.2 / 3)
    assert readers['memory_ms_per_frame.memory'].read(tr, run) == \
        pytest.approx(0.05 / 3)
    assert readers['load_ms_per_frame.call'].read(T.Trace(), run) is None
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


def test_breakdown_names_stay_apart_within_the_ledgers_width():
    """Operations of one span whose names part only past the ledger's 64
    characters (cuDNN's convolutions by tile size) read apart cut to 64;
    the others keep their names whole."""
    from vosbench.harness import trace as T
    conv = ('xmem.net.segment:sm90_xmma_fprop_implicit_gemm_bf16bf16_'
            'bf16f32_f32_nhwckrsc_nhwc_tilesize{}_warpgroupsize1x1x1_g1_'
            'execute_segment_k_off_kernel__5x_cudnn')
    names = [conv.format('64x128x64'), 'xmem.load:Memcpy HtoD',
             conv.format('128x128x64'), conv.format('256x128x64')]
    tr = T.Trace(span_ops=[(n, 1e-3 * i) for i, n in enumerate(names)])
    ops = T.breakdown(tr)['device_ops']
    assert [s for _, s in ops] == [0.0, 1e-3, 2e-3, 3e-3]
    assert ops[1][0] == 'xmem.load:Memcpy HtoD'
    cut = [n[:T.LEDGER_NAME] for n, _ in ops]
    assert len(set(cut)) == 4
    assert cut[0] == ('xmem.net.segment:sm90_xmma_fpro~tilesize64x128x64_'
                      'warpgroupsize1')
    assert all(n.endswith('_cudnn') for n, _ in ops[::2])


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
