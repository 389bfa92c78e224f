"""The card's time, two ways.

device_window: the measured window of every run, recorded by CUPTI with
the CUDA activity alone (no host events, nothing written to disk): the
seconds in which a kernel, copy or memset ran on the card.

window: the traced video of a --trace 1 run, torch.profiler over the host
and the card, with named ranges around calls into the program's layers,
read back from the profiler's Chrome trace by harness/spans.py report()
in one pass into what the per-layer metrics read: the card's time,
launches, operations and idle gaps by the program's spans, the declared
ranges' kernels, and each span's own times.

A metric's reader declares what it reads: in RANGES, {range name:
'module:Class.method'}, ranges that the driver wraps around each such
method for the window (a kernel belongs to a range when the host call
that launched it, the CUDA runtime event with the kernel's correlation
id, lies inside that range); in SPANS, names of the program's spans, or
prefixes ending in '.', which it reads from Trace.spans
(Trace.span_ms_per_frame).
"""

import contextlib
import importlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from vosbench.harness.spans import DEVICE_OPS, WINDOW, matches, report, union


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    launches: int = 0
    # device seconds of the kernels launched inside each declared range
    range_device_s: Dict[str, float] = field(default_factory=dict)
    # the longest idle gaps and device operations, by the program's spans
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    span_ops: List[Tuple[str, float]] = field(default_factory=list)
    # each span name's host_s, count, self_device_s and idle_s
    # (harness/spans.py report)
    spans: Dict[str, dict] = field(default_factory=dict)

    def span_ms_per_frame(self, names, frames) -> Optional[float]:
        """Self device milliseconds a frame of the spans named (exact
        names, or prefixes ending in '.'); None where the trace holds none
        of them or no frame was written."""
        hit = [v['self_device_s'] for n, v in self.spans.items()
               if matches(n, names)]
        if not hit or not frames:
            return None
        return 1e3 * sum(hit) / frames


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
    return sum(e - s for s, e in union(spans)) / 1e9, len(spans), kinds


def read(path: str, range_names) -> Trace:
    """The trace at path as a Trace over its WINDOW range: what
    harness/spans.py report() reads of its events, with the declared
    ranges' kernels among them."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    os.unlink(path)
    rep = report(events, ranges=range_names)
    if not rep['busy_s']:
        raise RuntimeError('the profiler recorded no device activity')
    return Trace(window_s=rep['window_s'], busy_s=rep['busy_s'],
                 launches=rep['launches'],
                 range_device_s=rep['range_device_s'],
                 idle_gaps=rep['idle_gaps'], span_ops=rep['span_ops'],
                 spans=rep['spans'])


# the ledger keeps the first 64 characters of a breakdown name
LEDGER_NAME = 64


def _apart(keys: List[str], width: int = LEDGER_NAME) -> List[str]:
    """Each key; one that shares its first width characters with another
    (cuDNN's kernels differ only in their tile sizes, far into the name)
    keeps its first half-width characters, then '~', then the rest from
    eight characters before it departs from the other, so that cut to
    width the two read apart."""
    out = []
    for k in keys:
        common = max((len(os.path.commonprefix([k, j])) for j in keys
                      if j != k), default=0)
        out.append(k if common < width else
                   k[:width // 2 - 1] + '~' + k[common - 8:])
    return out


def breakdown(t: Trace) -> dict:
    """The longest device operations, keyed '<innermost span>:<operation>'
    so that one operation launched from two layers reads as two (and kept
    apart within the ledger's width), and the longest idle gaps by what the
    host was doing."""
    keys = _apart([n for n, _ in t.span_ops])
    return {'device_ops': [[k, s] for k, (_, s) in zip(keys, t.span_ops)],
            'idle_gaps': [[n, s] for n, s in t.idle_gaps]}
