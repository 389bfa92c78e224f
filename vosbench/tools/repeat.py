"""Runs one cell several times, each run a process of its own as the
driver runs it, and prints each metric's median and spread (the distance
between the first and third quartile, statistics.quantiles(n=4), as a
share of the median), the way a bound is set. Beside each run it records
the host's state: the run's own CPU seconds (its process and those it
waited for), and before it started the dirty page cache, the free space
under TMPDIR, processes that were not there before the first run, and the
card's clock, temperature and power.

    python3 vosbench/tools/repeat.py --workload vos480-2obj \
        --seeds 1,2,3,4,5,6 [--seconds 30] [--trace 0] [--out DIR]

Writes each run's standard output and error under --out when given.
"""

import argparse
import json
import os
import resource
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float('nan'), med


def _meminfo_kb(*keys):
    with open('/proc/meminfo') as f:
        rows = dict(line.split(':', 1) for line in f)
    return {k: int(rows[k].split()[0]) for k in keys}


def _other_processes():
    """Processes other than this one, its parent and the kernel's threads
    (which have no command line)."""
    mine = {os.getpid(), os.getppid()}
    out = []
    for d in os.listdir('/proc'):
        if not d.isdigit() or int(d) in mine:
            continue
        try:
            with open(f'/proc/{d}/cmdline', 'rb') as f:
                cmd = f.read().replace(b'\0', b' ').decode().strip()
        except OSError:
            continue
        if cmd:
            out.append(cmd[:80])
    return out


def _card():
    """SM clock (MHz), temperature (C) and power draw (W) of the card."""
    try:
        q = subprocess.run(
            ['nvidia-smi', '--query-gpu=clocks.sm,temperature.gpu,'
             'power.draw', '--format=csv,noheader,nounits'],
            capture_output=True, text=True, timeout=30).stdout
        return [float(v) for v in q.split('\n')[0].split(',')]
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def host_before():
    return {'ru': resource.getrusage(resource.RUSAGE_CHILDREN),
            'mem_kb': _meminfo_kb('Dirty', 'Writeback', 'MemAvailable'),
            'others': _other_processes(), 'card': _card(),
            'tmp_free_gb': shutil.disk_usage(
                os.environ.get('TMPDIR', '/tmp')).free / 2 ** 30}


def run_cpu_s(before) -> float:
    ru = resource.getrusage(resource.RUSAGE_CHILDREN)
    return (ru.ru_utime - before['ru'].ru_utime) + \
        (ru.ru_stime - before['ru'].ru_stime)


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float)
    p.add_argument('--trace', type=int, default=0)
    p.add_argument('--out')
    a = p.parse_args()
    seconds = a.seconds or json.loads(
        (ROOT / 'BENCHMARK.json').read_text())['run_seconds']
    rows, baseline = [], None
    for seed in a.seeds.split(','):
        before = host_before()
        t = time.perf_counter()
        run = subprocess.run(
            [sys.executable, 'vosbench/run.py', '--workload', a.workload,
             '--seed', seed, '--seconds', str(seconds), '--trace',
             str(a.trace)], cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t
        host = dict(run_cpu_s=run_cpu_s(before), card=before['card'],
                    tmp_free_gb=before['tmp_free_gb'], **before['mem_kb'])
        if a.out:
            out = Path(a.out)
            out.mkdir(parents=True, exist_ok=True)
            (out / f'{a.workload}_{a.trace}_{seed}.out').write_text(run.stdout)
            (out / f'{a.workload}_{a.trace}_{seed}.err').write_text(run.stderr)
        line = run.stdout.strip().splitlines()[-1] if run.stdout.strip() \
            else '{}'
        res = json.loads(line) if run.returncode == 0 else {}
        row = {'seed': seed, 'rc': run.returncode, 'wall_s': wall,
               'correct': res.get('correct'),
               'metrics': {k: v['value'] for k, v in
                           res.get('metrics', {}).items()},
               'checks': {k: v['value'] for k, v in
                          res.get('checks', {}).items()},
               'peak': res.get('device', {}).get('memory_peak_bytes'),
               'host': host}
        if baseline is None:
            baseline = set(before['others'])
        new = sorted(set(before['others']) - baseline)
        if new:     # processes that were not there before the first run
            row['new_processes'] = new[:20]
        print(json.dumps(row), flush=True)
        if run.returncode != 0:
            print(run.stderr[-3000:], file=sys.stderr, flush=True)
        rows.append(row)
    names = sorted({k for r in rows for k in r['metrics']})
    summary = {}
    for k in names:
        vals = [r['metrics'][k] for r in rows if k in r['metrics']]
        if len(vals) >= 2:
            s, med = spread(vals)
            summary[k] = {'median': med, 'spread': s, 'values': vals}
            if len(vals) >= 3:   # without the run farthest from the median
                far = max(vals, key=lambda v: abs(v - med))
                rest = list(vals)
                rest.remove(far)
                summary[k]['spread_trimmed'] = spread(rest)[0]
    print(json.dumps({'workload': a.workload, 'summary': summary}),
          flush=True)


if __name__ == '__main__':
    main()
