"""The readings that the limit of a cell of the video driver
(drivers/video.py) is set from, on the card at the cell's own size: for
each seed, the program over one whole video against the float32 reference
(the lower reading), and for the first seeds the control, the reference
itself in float8 in the program's place (the upper reading), and the
program with each planted fault (tests/faults.py). One process for all
seeds, since set-up is most of a run.

    python3 vosbench/tests/readings.py --workload vos480-2obj \
        --seeds 11,12,13 --control 3

Prints one JSON line a seed and a summary line.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from vosbench.drivers import video as D  # noqa: E402
from vosbench.harness import common  # noqa: E402
from vosbench.harness.videos import palette  # noqa: E402
from vosbench.reference import compare, vos  # noqa: E402
from vosbench.tests.faults import FAULTS, planted  # noqa: E402

# margins read besides the cell's own, to choose it from
MARGINS = (0.05, 0.1, 0.2, 0.3)


def readings(cell, seeds, control: int, dev: str = 'cuda'):
    from xmem2_tpu_torch.inference.run_on_video import run_on_video
    chk = cell.traffic['check']
    pal = palette(len(cell.traffic['video']['first_frames']))
    out = []
    for i, seed in enumerate(seeds):
        work = Path(tempfile.mkdtemp(prefix='vosbench-readings-',
                                     dir=os.environ.get('TMPDIR')))
        try:
            t = time.perf_counter()
            videos, ckpt = D.setup(cell, seed, work, dev)
            cfg = D._program_config(cell, ckpt)
            D._one_video(run_on_video, videos[0], work / 'out', cfg, dev)
            ref = vos.run_video(videos[0]['frames'], videos[0]['annotations'],
                                ckpt, cell.config['inference'], dev, 'f32')
            bad, diff, n = compare.confident_mismatch(
                str(work / 'out' / 'masks'), ref, pal, chk['margin'])
            row = {'seed': seed, 'program': bad, 'program_all_pixels': diff,
                   'frames': n, 'by_margin': {
                       'program': compare.confident_mismatch(
                           str(work / 'out' / 'masks'), ref, pal,
                           MARGINS)[0]}}
            if i < control:
                low = vos.run_video(videos[0]['frames'],
                                    videos[0]['annotations'], ckpt,
                                    cell.config['inference'], dev, 'fp8')
                row['control'], row['control_all_pixels'], _ = \
                    compare.mismatch(low.labels, ref, chk['margin'])
                row['by_margin']['control'] = compare.mismatch(
                    low.labels, ref, MARGINS)[0]
                for fault in FAULTS:
                    out_f = work / fault.replace(' ', '_')
                    with planted(fault):
                        D._one_video(run_on_video, videos[0], out_f, cfg,
                                     dev)
                    row[fault] = compare.confident_mismatch(
                        str(out_f / 'masks'), ref, pal, chk['margin'])[0]
                    row['by_margin'][fault] = compare.confident_mismatch(
                        str(out_f / 'masks'), ref, pal, MARGINS)[0]
            row['seconds'] = time.perf_counter() - t
            print(json.dumps(row), flush=True)
            out.append(row)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--control', type=int, default=3)
    a = p.parse_args()
    cell = common.Cell(a.workload)
    common.check_device(cell.chips)
    rows = readings(cell, [int(s) for s in a.seeds.split(',')], a.control)
    prog = [r['program'] for r in rows]
    ctrl = [r['control'] for r in rows if 'control' in r]
    faults = {f: min(r[f] for r in rows if f in r) for f in FAULTS
              if any(f in r for r in rows)}
    print(json.dumps({'workload': a.workload, 'lower': max(prog),
                      'upper': min(ctrl) if ctrl else None,
                      'faults_least': faults, 'program': prog,
                      'control': ctrl}), flush=True)


if __name__ == '__main__':
    main()
