"""CUDA kernel launches in the traced window over the frames finished in
it (torch.profiler kernel events)."""


def read(trace, run):
    if not run.frames or not trace.launches:
        return None
    return trace.launches / run.frames
