"""The card's time, two ways.

device_window: the measured window of every run, recorded by CUPTI with
the CUDA activity alone (no host events, nothing written to disk): the
seconds in which a kernel, copy or memset ran on the card.

window: the traced video of a --trace 1 run, torch.profiler over the host
and the card, with named ranges around calls into the program's layers,
read back from the profiler's Chrome trace into what the per-layer
metrics read.

A metric's reader declares the ranges it reads in RANGES, {range name:
'module:Class.method'}; the driver wraps each such method in a range of
that name for the window. A kernel belongs to a range when the host call
that launched it (the CUDA runtime event with the kernel's correlation id)
lies inside that range.
"""

import bisect
import contextlib
import importlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = 'vosbench.window'
# the profiler's activity types of operations that run on the card
DEVICE_OPS = ('kernel', 'gpu_memcpy', 'gpu_memset')


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    launches: int = 0
    # device seconds of the kernels launched inside each declared range
    range_device_s: Dict[str, float] = field(default_factory=dict)
    # every device operation's name (kernels, copies, memsets): its device
    # seconds, and how many times it ran
    op_s: Dict[str, float] = field(default_factory=dict)
    op_count: Dict[str, int] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def declared_ranges(readers) -> Dict[str, str]:
    """The union of the readers' RANGES; one name, one target."""
    out: Dict[str, str] = {}
    for r in readers:
        for name, target in getattr(r, 'RANGES', {}).items():
            if out.setdefault(name, target) != target:
                raise ValueError(f'range {name!r} declared for both '
                                 f'{out[name]!r} and {target!r}')
    return out


def _resolve(target: str):
    """'package.module:Class.method' -> (Class, 'method')."""
    mod, _, path = target.partition(':')
    *owner_path, attr = path.split('.')
    owner = importlib.import_module(mod)
    for part in owner_path:
        owner = getattr(owner, part)
    return owner, attr


@contextlib.contextmanager
def ranges(declared: Dict[str, str]):
    """Each declared target wrapped in torch.profiler.record_function(its
    range name) inside the block."""
    from torch.profiler import record_function
    saved = []
    for name, target in declared.items():
        owner, attr = _resolve(target)
        fn = getattr(owner, attr)

        def wrapped(*a, __fn=fn, __name=name, **k):
            with record_function(__name):
                return __fn(*a, **k)
        saved.append((owner, attr, fn))
        setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


@contextlib.contextmanager
def window(path: str):
    """Profiles the block (CPU and CUDA activities) as one WINDOW range,
    and writes the Chrome trace to path."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


@dataclass
class DeviceTime:
    busy_s: Optional[float] = None     # None where nothing was recorded
    ops: int = 0
    kinds: Dict[str, int] = field(default_factory=dict)


@contextlib.contextmanager
def device_window(on: bool = True):
    """Records the card's operations in the block; after it, the yielded
    DeviceTime holds the length of the union of their times. Off (the CPU
    rehearsals): records nothing."""
    out = DeviceTime()
    if not on:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield out
    out.busy_s, out.ops, out.kinds = device_busy(
        prof.profiler.kineto_results.events())


def device_busy(events) -> Tuple[Optional[float], int, Dict[str, int]]:
    """Seconds in which an operation of DEVICE_OPS ran on the card (the
    union of their spans), how many ran, and every CUDA-side activity type
    seen with its count. Seconds are None where none ran."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans, kinds = [], {}
    for e in events:
        if e.device_type() != cuda:
            continue
        kind = e.activity_type() if hasattr(e, 'activity_type') else None
        kinds[str(kind)] = kinds.get(str(kind), 0) + 1
        if kind is None:    # profilers that do not name the activity
            if hasattr(e, 'is_user_annotation') and e.is_user_annotation():
                continue
        elif kind not in DEVICE_OPS:
            continue
        if hasattr(e, 'start_ns'):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = e.start_us() * 1000, e.duration_us() * 1000
        spans.append((s, s + d))
    if not spans:
        return None, 0, kinds
    return _union(spans)[0] / 1e9, len(spans), kinds


def _union(intervals):
    """Total length of a union of (start, end) intervals, and the gaps
    between them as (start, end)."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def read(path: str, range_names) -> Trace:
    """The trace at path as a Trace over its WINDOW range."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    win = [e for e in events if e.get('name') == WINDOW
           and e.get('cat') == 'user_annotation']
    if not win:
        raise RuntimeError('the trace has no window range')
    w0, w1 = win[0]['ts'], win[0]['ts'] + win[0]['dur']
    device, launch_ts, rng, host = [], {}, {n: [] for n in range_names}, []
    for e in events:
        cat = e.get('cat')
        if e.get('ph') != 'X':
            continue
        if cat in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            device.append(e)
        elif cat in ('cuda_runtime', 'cuda_driver'):
            c = e.get('args', {}).get('correlation')
            if c is not None:
                launch_ts[c] = e['ts']
        elif cat in ('cpu_op', 'user_annotation') and e['name'] != WINDOW:
            host.append((e['ts'], e['ts'] + e['dur'], e['name']))
            if e['name'] in rng:
                rng[e['name']].append((e['ts'], e['ts'] + e['dur']))
    device = [e for e in device if w0 <= e['ts'] and e['ts'] + e['dur'] <= w1]
    if not device:
        raise RuntimeError('the profiler recorded no device activity')
    t = Trace(window_s=(w1 - w0) / 1e6)
    busy, gaps = _union([(e['ts'], e['ts'] + e['dur']) for e in device])
    t.busy_s = busy / 1e6
    kernels = [e for e in device if e.get('cat') == 'kernel']
    t.launches = len(kernels)
    starts = {n: sorted(v) for n, v in rng.items()}
    t.range_device_s = dict.fromkeys(starts, 0.0)
    for k in kernels:
        ts = launch_ts.get(k.get('args', {}).get('correlation'))
        if ts is None:
            continue
        for n, iv in starts.items():
            i = bisect.bisect_right(iv, (ts, float('inf'))) - 1
            if i >= 0 and iv[i][0] <= ts <= iv[i][1]:
                t.range_device_s[n] += k['dur'] / 1e6
    for k in device:
        t.op_s[k['name']] = t.op_s.get(k['name'], 0.0) + k['dur'] / 1e6
        t.op_count[k['name']] = t.op_count.get(k['name'], 0) + 1
    t.idle_gaps = _label_gaps(gaps, host)
    os.unlink(path)
    return t


def _label_gaps(gaps, host, top: int = 10):
    """The longest idle gaps, each named by the innermost host operation
    or benchmark range running at its middle ('host (no operation)':
    Python outside every operation and range, such as the frame loop of
    run_on_video)."""
    host.sort()
    starts = [h[0] for h in host]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid)
        name, best = 'host (no operation)', None
        for h in host[max(0, i - 2000):i]:
            if h[0] <= mid <= h[1] and (best is None or h[1] - h[0] < best):
                name, best = h[2], h[1] - h[0]
        out.append((name, (e - s) / 1e6))
    return out


def breakdown(t: Trace) -> dict:
    top = sorted(t.op_s.items(), key=lambda kv: -kv[1])[:10]
    return {'device_ops': [[n, s] for n, s in top],
            'idle_gaps': [[n, s] for n, s in t.idle_gaps]}
