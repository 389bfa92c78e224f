"""What every run of the benchmark shares: the command line, the checkout's
files found by name, the device checks, the guard against JAX, and the
result line."""

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]      # the checkout
BENCH = Path(__file__).resolve().parents[1]     # vosbench/
# top-level module names that must not be loaded: JAX, and the JAX package
# whose name the port's begins with (compared whole)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'xmem2_tpu')
THREADS = 2     # CPU threads of each process of a run (set_environment)


class Refused(Exception):
    """A run that must end without a result line (exit code 2)."""


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='one run of one benchmark cell')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cells(driver: Optional[str] = None) -> List[str]:
    """The names of BENCHMARK.json's cells; with a driver, only those whose
    traffic file names it."""
    bench = load_json(ROOT / 'BENCHMARK.json')
    return [w['name'] for w in bench['workloads'] if driver is None
            or load_json(BENCH / 'workloads' / f'{w["traffic"]}.json')
            .get('driver') == driver]


class Cell:
    """One cell's pieces, found by name: its BENCHMARK.json entry, its
    traffic file, its configuration file, its driver and its metrics."""

    def __init__(self, name: str):
        bench = load_json(ROOT / 'BENCHMARK.json')
        entry = [w for w in bench['workloads'] if w['name'] == name]
        if not entry:
            raise Refused(f'no workload {name!r} in BENCHMARK.json')
        self.entry = entry[0]
        self.name = name
        self.chips = int(self.entry['chips'])
        self.traffic = load_json(BENCH / 'workloads'
                                 / f'{self.entry["traffic"]}.json')
        if self.traffic.get('config') != self.entry['config']:
            raise Refused(f'{name}: traffic file names config '
                          f'{self.traffic.get("config")!r}, BENCHMARK.json '
                          f'{self.entry["config"]!r}')
        cfg = [c for c in bench['configs'] if c['name'] == self.entry['config']]
        if not cfg:
            raise Refused(f'{name}: no configuration '
                          f'{self.entry["config"]!r} in BENCHMARK.json')
        self.config = load_json(ROOT / cfg[0]['file'])
        self.end_to_end = [m for m in bench['end_to_end']
                           if name in m.get('workloads', [name])]
        self.per_layer = [m for m in bench['per_layer']
                          if name in m.get('workloads', [name])]

    def driver(self):
        return load_module(BENCH / 'drivers' / f'{self.traffic["driver"]}.py')

    def readers(self) -> Dict[str, object]:
        """The per-layer metrics' readers: vosbench/metrics/<name>.py, each
        with read(trace, run) -> a number, or None where it finds nothing
        to read, and optionally RANGES and SPANS (harness/trace.py)."""
        return {m['name']: load_module(BENCH / 'metrics' / f'{m["name"]}.py')
                for m in self.per_layer}


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        'vosbench_' + path.stem.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_device(chips: int) -> dict:
    """The cards this run uses; Refused without as many CUDA cards."""
    import torch
    if not torch.cuda.is_available():
        raise Refused('no CUDA device: the benchmark runs on the card only')
    if torch.cuda.device_count() < chips:
        raise Refused(f'{torch.cuda.device_count()} CUDA devices, the cell '
                      f'needs {chips}')
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': chips}


def forbidden_modules() -> List[str]:
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(FORBIDDEN))


def stop_helper_processes():
    """Stops multiprocessing's resource tracker, which the program's PNG
    writers start, and waits for it: left to itself it outlives the run's
    process by a moment, and where nothing reaps orphans it stays behind
    as an exited child."""
    from multiprocessing import resource_tracker
    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        if tracker._pid is not None:
            os.close(tracker._fd)
            os.waitpid(tracker._pid, 0)
            tracker._fd = tracker._pid = None


def set_environment():
    """Build and kernel caches at fixed paths inside the checkout (the
    program's nvcc output goes to build/ there by itself), no JAX through
    other libraries, and few CPU threads: the run's process and the PNG
    writers it spawns share the host's cores, and a parallel region waits
    for its slowest thread when those cores are contended. Called before
    torch is imported."""
    os.environ['OMP_NUM_THREADS'] = os.environ['MKL_NUM_THREADS'] = \
        str(THREADS)
    cache = ROOT / 'build' / 'vosbench-cache'
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_ext')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def log(*a):
    """Progress on standard error."""
    print('[vosbench]', *a, file=sys.stderr, flush=True)


def emit(result: dict, checks: Dict[str, dict]):
    """The compared numbers beside their limits as the last lines of
    standard error, and the result as the last line of standard output,
    with the checks under the last key."""
    for name, c in checks.items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr, flush=True)
    line = dict(result)
    line['checks'] = checks
    print(json.dumps(line), flush=True)
