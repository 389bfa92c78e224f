"""Where a video cell's traced video spends the card's time, by the
program's own spans (harness/spans.py).

    python3 vosbench/tools/spans.py --workload vos480-2obj --seed <n> \
        [--videos 3] [--out FILE]

Sets up as a run of the video driver does (the cell's videos and seeded
weights from the seed, one warm-up video), then runs --videos more videos,
each under the profiler as the traced video of a --trace 1 run is
(harness/trace.py window, with the ranges that the cell's readers
declare). Prints a JSON line a video: its host seconds, what the readers'
Trace holds (harness/trace.py read and breakdown), the program's counters
where it keeps them, the spans' report read from the same trace file, and
for every reader of the cell that declares SPANS its value from
Trace.spans ('span_readers') beside the self device milliseconds a frame
of the same spans summed from the report ('report_ms_per_frame'), and the
share of the idle time outside the frame loop ('xmem.loop'). Against a
program without spans the report puts all the card's time outside every
span. --out also writes the lines to FILE. Drives the video driver's own
steps (_program_config, _one_video), so a cell of another driver is
refused.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from vosbench.harness import common, spans  # noqa: E402
from vosbench.harness import trace as T  # noqa: E402


def _counters():
    from xmem2_tpu_torch.utils import profiling
    read = getattr(profiling, 'counters', None)
    return read() if read else None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--videos', type=int, default=1)
    p.add_argument('--out')
    a = p.parse_args(argv)
    common.set_environment()
    cell = common.Cell(a.workload)
    if cell.traffic['driver'] != 'video':
        raise SystemExit(f'{a.workload}: driver {cell.traffic["driver"]!r}; '
                         'tools/spans.py drives the video driver alone')
    common.check_device(cell.chips)
    import torch
    from xmem2_tpu_torch.inference.run_on_video import run_on_video

    drv = cell.driver()
    work = Path(tempfile.mkdtemp(prefix='vosbench-spans-',
                                 dir=os.environ.get('TMPDIR')))
    lines = []
    try:
        videos, ckpt = drv.setup(cell, a.seed, work)
        cfg = drv._program_config(cell, ckpt)
        drv._one_video(run_on_video, videos[-1], work / 'warm', cfg, 'cuda')
        torch.cuda.synchronize()
        readers = cell.readers()
        declared = T.declared_ranges(readers.values())
        by_spans = {n: r for n, r in readers.items() if hasattr(r, 'SPANS')}
        for i in range(a.videos):
            path = str(work / 'trace.json')
            with T.ranges(declared), T.window(path):
                t0 = time.perf_counter()
                frames = drv._one_video(run_on_video, videos[i % len(videos)],
                                        work / f'out{i}', cfg, 'cuda')
                host_s = time.perf_counter() - t0
            with open(path) as f:
                rep = spans.report(json.load(f)['traceEvents'])
            tr = T.read(path, declared)
            line = {
                'video': i, 'seed': a.seed, 'frames': frames,
                'host_s': host_s, 'window_s': tr.window_s,
                'busy_s': tr.busy_s, 'launches': tr.launches,
                'range_device_s': tr.range_device_s,
                'breakdown': T.breakdown(tr), 'counters': _counters(),
                'span_readers': {n: r.read(tr, SimpleNamespace(frames=frames))
                                 for n, r in by_spans.items()},
                'report_ms_per_frame': {
                    n: 1e3 * sum(v['self_device_s'] for k, v
                                 in rep['spans'].items()
                                 if spans.matches(k, r.SPANS)) / frames
                    for n, r in by_spans.items()},
                'call_idle_share': 100.0 * rep['idle_outside_loop_s']
                / rep['idle_s'] if rep['idle_s'] else None,
                'spans': rep}
            lines.append(json.dumps(line))
            print(lines[-1], flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text('\n'.join(lines) + '\n')
    common.stop_helper_processes()


if __name__ == '__main__':
    main()
