"""Tracing and profiling hooks.

Counterpart of xmem2_tpu/utils/profiling.py: torch.profiler in place of
jax.profiler, and the same host-side stage timer.

    with device_trace('/tmp/trace', device):     # no-op when dir is None/''
        ... per-frame loop ...                    # -> /tmp/trace/trace.json

    timer = StageTimer()
    with timer.stage('encode'):
        ...
    print(timer.report())

`python -m xmem2_tpu_torch.eval --profile_dir` writes a trace through
device_trace; the training CLI's --stats reads its profile window through
profiler().
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Optional

import torch


def profiler(device=None):
    """A torch.profiler.profile over the host and, when `device` is a CUDA
    device (or None with CUDA present), the card's kernels."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == 'cuda' if device is not None \
        else torch.cuda.is_available()
    return profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str], device=None):
    """A torch.profiler trace of everything inside the context, written as
    trace_dir/trace.json (Chrome trace format: chrome://tracing, Perfetto).
    No-op without a dir, so call sites can pass the flag through."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, 'trace.json')
    with profiler(device) as prof:
        yield
    prof.export_chrome_trace(path)
    print(f'torch.profiler trace written to {path}')


class StageTimer:
    """Host wall clock accumulated per stage (the perf_counter layer of the
    reference's instrumentation, run_on_video.py:106-113)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f'{name}: {t:.3f}s total, {t / max(c, 1) * 1000:.2f}'
                         f' ms/call over {c} calls')
        return '\n'.join(lines)


def annotate(name: str):
    """A named range in the trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
