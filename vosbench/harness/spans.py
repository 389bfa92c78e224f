"""The program's own spans in a profiler trace: where the card's time and
its idle time fall among the annotations that the program opens around
its work (the port's 'xmem.' spans, xmem2_tpu_torch/utils/profiling.py).

report(events) takes the Chrome trace events of a window (harness/trace.py
window) and returns, for every span name: its host seconds, its self
device seconds (the kernels, copies and memsets whose launching runtime
call lies innermost in a span of that name) and the device-idle seconds
inside it; the longest idle gaps, each named by the innermost span at its
middle, found by interval search over the whole trace (where no span is
open there, by the innermost host operation or benchmark range); the
share of the device time launched outside every span; the longest
operations keyed '<innermost span>:<operation>'; the kernels launched;
and, for each benchmark range named, the device seconds of the kernels
launched inside it. harness/trace.py read() keeps what the per-layer
metrics read of it.

Where the program opens no spans (a program from before they existed)
everything falls under OUTSIDE.
"""

import bisect
from typing import Dict, List, Optional, Tuple

WINDOW = 'vosbench.window'
# the profiler's activity types of operations that run on the card
DEVICE_OPS = ('kernel', 'gpu_memcpy', 'gpu_memset')
PREFIX = 'xmem.'
OUTSIDE = '(outside every span)'
UNLAUNCHED = '(no launch recorded)'


def _innermost_segments(spans):
    """Properly nested (start, end, name) spans of one thread -> the
    segment starts and the innermost span's name over each segment (None
    outside every span)."""
    starts, names, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            starts.append(end)
            names.append(stack[-1][2] if stack else None)
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        starts.append(s)
        names.append(name)
        stack.append((s, e, name))
    close_until(float('inf'))
    return starts, names


class _Innermost:
    """The innermost span at a time on a thread, by binary search."""

    def __init__(self, spans_by_tid):
        self.segments = {tid: _innermost_segments(sp)
                         for tid, sp in spans_by_tid.items()}

    def at(self, tid, t) -> Optional[str]:
        seg = self.segments.get(tid)
        if seg is None:
            return None
        i = bisect.bisect_right(seg[0], t) - 1
        return seg[1][i] if i >= 0 else None


def union(intervals):
    """(start, end) intervals -> their union as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(e, out[-1][1]))
        else:
            out.append((s, e))
    return out


def _busy_within(merged, cum, s, e) -> float:
    """Length of the union of busy intervals (merged: sorted, disjoint;
    cum[i]: the length of merged[:i]) that lies inside [s, e]."""
    def upto(t):
        i = bisect.bisect_right(merged, (t, float('inf'))) - 1
        if i < 0:
            return 0.0
        b0, b1 = merged[i]
        return cum[i] + min(t, b1) - b0
    return upto(e) - upto(s)


def window_bounds(events) -> Tuple[float, float]:
    """Start and end (us) of the trace's WINDOW range."""
    win = [e for e in events if e.get('name') == WINDOW
           and e.get('cat') == 'user_annotation']
    if not win:
        raise RuntimeError('the trace has no window range')
    return win[0]['ts'], win[0]['ts'] + win[0]['dur']


def matches(name: str, names) -> bool:
    """Whether a span name is one of names: exact names, or prefixes
    ending in '.'."""
    return any(name == m or (m.endswith('.') and name.startswith(m))
               for m in names)


def _inside(intervals, t) -> bool:
    """Whether t lies in the last of the sorted (start, end) intervals that
    starts at or before it."""
    i = bisect.bisect_right(intervals, (t, float('inf'))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def report(events, prefix: str = PREFIX, top: int = 10,
           ranges=()) -> dict:
    """What the program's spans say of the window's card time (seconds);
    ranges: names of benchmark ranges (harness/trace.py ranges) whose
    kernels' device seconds to count, a kernel belonging to a range when
    its launch lies inside one of that name on any thread."""
    w0, w1 = window_bounds(events)
    spans, others, launches, device = {}, {}, {}, []
    rng = {n: [] for n in ranges}
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat = e.get('cat')
        if cat in DEVICE_OPS:
            if w0 <= e['ts'] and e['ts'] + e['dur'] <= w1:
                device.append(e)
        elif cat in ('cuda_runtime', 'cuda_driver'):
            c = e.get('args', {}).get('correlation')
            if c is not None:
                launches[c] = (e.get('tid'), e['ts'])
        elif cat in ('cpu_op', 'user_annotation') and e['name'] != WINDOW:
            (spans if e['name'].startswith(prefix) else others).setdefault(
                e.get('tid'), []).append(
                    (e['ts'], e['ts'] + e['dur'], e['name']))
            if e['name'] in rng:
                rng[e['name']].append((e['ts'], e['ts'] + e['dur']))
    rng = {n: sorted(iv) for n, iv in rng.items()}
    inner = _Innermost(spans)
    merged = union([(d['ts'], d['ts'] + d['dur']) for d in device])
    cum = [0.0]
    for b0, b1 in merged:
        cum.append(cum[-1] + b1 - b0)
    busy = cum[-1]
    gaps = list(zip([b1 for _, b1 in merged[:-1]],
                    [b0 for b0, _ in merged[1:]]))

    def idle_in(s, e):
        a, b = max(s, w0), min(e, w1)
        return (b - a - _busy_within(merged, cum, a, b)) / 1e6 \
            if b > a else 0.0

    names = sorted({n for sp in spans.values() for _, _, n in sp})
    out = {n: {'host_s': 0.0, 'count': 0, 'self_device_s': 0.0,
               'idle_s': 0.0} for n in names + [OUTSIDE, UNLAUNCHED]}
    for sp in spans.values():
        for s, e, n in sp:
            out[n]['host_s'] += (e - s) / 1e6
            out[n]['count'] += 1
            out[n]['idle_s'] += idle_in(s, e)
    span_ops: Dict[str, float] = {}
    range_s = dict.fromkeys(rng, 0.0)
    kernels = 0
    for d in device:
        at = launches.get(d.get('args', {}).get('correlation'))
        label = UNLAUNCHED if at is None else (inner.at(*at) or OUTSIDE)
        s = d['dur'] / 1e6
        out[label]['self_device_s'] += s
        key = f'{label}:{d["name"]}'
        span_ops[key] = span_ops.get(key, 0.0) + s
        if d['cat'] == 'kernel':
            kernels += 1
            for n, iv in rng.items():
                if at is not None and _inside(iv, at[1]):
                    range_s[n] += s
    main = _main_thread(spans) or _main_thread(others)
    idle = (w1 - w0 - busy) / 1e6
    outside_loop = idle - sum(idle_in(s, e) for s, e, n
                              in spans.get(main, []) if n == prefix + 'loop')
    device_s = sum(d['dur'] for d in device) / 1e6
    return {
        'window_s': (w1 - w0) / 1e6, 'busy_s': busy / 1e6, 'idle_s': idle,
        'launches': kernels, 'range_device_s': range_s,
        'idle_outside_loop_s': outside_loop,
        'device_s': device_s,
        'outside_share': (out[OUTSIDE]['self_device_s']
                          + out[UNLAUNCHED]['self_device_s'])
        / device_s if device_s else None,
        'spans': {n: v for n, v in out.items() if v['count']
                  or v['self_device_s']},
        'idle_gaps': _label_gaps(gaps, inner, _Innermost(others), main,
                                 top),
        'span_ops': sorted(([k, v] for k, v in span_ops.items()),
                           key=lambda kv: -kv[1])[:top],
    }


def _main_thread(spans) -> Optional[int]:
    """The thread with the most span time (the one that runs the call)."""
    if not spans:
        return None
    return max(spans, key=lambda t: sum(e - s for s, e, _ in spans[t]))


def _label_gaps(gaps, inner: _Innermost, host: _Innermost, tid, top: int
                ) -> List[Tuple[str, float]]:
    """The longest idle gaps, each named by the innermost span of the
    calling thread at its middle; where none is open, by its innermost
    host operation or benchmark range there; OUTSIDE where none is."""
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        out.append((inner.at(tid, mid) or host.at(tid, mid) or OUTSIDE,
                    (e - s) / 1e6))
    return out
