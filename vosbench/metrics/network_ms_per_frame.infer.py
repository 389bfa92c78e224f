"""Device milliseconds a frame of the kernels launched inside ranges
around XMemNet.encode_key, segment and encode_value."""

_NET = 'xmem2_tpu_torch.inference.net:XMemNet.'
RANGES = {f'vosbench.{m}': _NET + m
          for m in ('encode_key', 'segment', 'encode_value')}


def read(trace, run):
    s = sum(trace.range_device_s.get(r, 0.0) for r in RANGES)
    if not run.frames or s <= 0:
        return None
    return 1e3 * s / run.frames
