"""The program's own spans in a profiler trace: where the card's time and
its idle time fall among the annotations that the program opens around
its work (the port's 'xmem.' spans, xmem2_tpu_torch/utils/profiling.py).

report(events) takes the Chrome trace events of a window (harness/trace.py
window) and returns, for every span name: its host seconds, its self
device seconds (the kernels, copies and memsets whose launching runtime
call lies innermost in a span of that name) and the device-idle seconds
inside it; the longest idle gaps, each named by the innermost span at its
middle, found by interval search over the whole trace; the share of the
device time launched outside every span; and the device seconds of each
of the longest operations by the span that launched them.

Where the program opens no spans (a program from before they existed)
everything falls under OUTSIDE.
"""

import bisect
from typing import Dict, List, Optional, Tuple

from vosbench.harness.trace import DEVICE_OPS, WINDOW

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


def _merge(intervals):
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


def report(events, prefix: str = PREFIX, top: int = 10) -> dict:
    """What the program's spans say of the window's card time (seconds)."""
    win = [e for e in events if e.get('name') == WINDOW
           and e.get('cat') == 'user_annotation']
    if not win:
        raise RuntimeError('the trace has no window range')
    w0, w1 = win[0]['ts'], win[0]['ts'] + win[0]['dur']
    spans, launches, device = {}, {}, []
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
        elif cat in ('cpu_op', 'user_annotation') \
                and e['name'].startswith(prefix):
            spans.setdefault(e.get('tid'), []).append(
                (e['ts'], e['ts'] + e['dur'], e['name']))
    inner = _Innermost(spans)
    merged = _merge([(d['ts'], d['ts'] + d['dur']) for d in device])
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
    ops: Dict[str, Dict[str, float]] = {}
    op_total: Dict[str, float] = {}
    for d in device:
        at = launches.get(d.get('args', {}).get('correlation'))
        label = UNLAUNCHED if at is None else (inner.at(*at) or OUTSIDE)
        out[label]['self_device_s'] += d['dur'] / 1e6
        by = ops.setdefault(d['name'], {})
        by[label] = by.get(label, 0.0) + d['dur'] / 1e6
        op_total[d['name']] = op_total.get(d['name'], 0.0) + d['dur'] / 1e6
    main = _main_thread(spans)
    idle = (w1 - w0 - busy) / 1e6
    outside_loop = idle - sum(idle_in(s, e) for s, e, n
                              in spans.get(main, []) if n == prefix + 'loop')
    device_s = sum(op_total.values())
    return {
        'window_s': (w1 - w0) / 1e6, 'busy_s': busy / 1e6, 'idle_s': idle,
        'idle_outside_loop_s': outside_loop,
        'device_s': device_s,
        'outside_share': (out[OUTSIDE]['self_device_s']
                          + out[UNLAUNCHED]['self_device_s'])
        / device_s if device_s else None,
        'spans': {n: v for n, v in out.items() if v['count']
                  or v['self_device_s']},
        'idle_gaps': _label_gaps(gaps, inner, main, top),
        'ops_by_span': [[n, op_total[n], sorted(ops[n].items(),
                                                key=lambda kv: -kv[1])]
                        for n in sorted(op_total, key=lambda n: -op_total[n])
                        [:top]],
    }


def _main_thread(spans) -> Optional[int]:
    """The thread with the most span time (the one that runs the call)."""
    if not spans:
        return None
    return max(spans, key=lambda t: sum(e - s for s, e, _ in spans[t]))


def _label_gaps(gaps, inner: _Innermost, tid, top: int
                ) -> List[Tuple[str, float]]:
    """The longest idle gaps, each named by the innermost span of the
    calling thread at its middle (OUTSIDE where none is open)."""
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        out.append((inner.at(tid, (s + e) / 2) or OUTSIDE, (e - s) / 1e6))
    return out


def per_frame_ms(rep: dict, names, frames: float) -> Optional[float]:
    """Self device milliseconds a frame of the spans named (exact names,
    or prefixes ending in '.')."""
    s = sum(v['self_device_s'] for n, v in rep['spans'].items()
            if any(n == m or (m.endswith('.') and n.startswith(m))
                   for m in names))
    return 1e3 * s / frames if frames else None
