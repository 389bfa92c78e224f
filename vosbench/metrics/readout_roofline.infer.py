"""The least time of every readout of the traced video (reference/work.py,
from the reference's memory sizes at the cell's shapes) over the device
time of the kernels launched inside ranges around
MemoryManager.match_query, in percent."""

from vosbench.reference import work

RANGE = 'vosbench.match_query'
RANGES = {RANGE: 'xmem2_tpu_torch.memory.manager:MemoryManager.match_query'}


def read(trace, run):
    inf = run.config['inference']
    vbytes = 2 if run.program['value_store_dtype'] == 'bfloat16' else 4
    least = work.readouts_least_seconds(run.record.readouts, inf['key_dim'],
                                        inf['value_dim'], inf['top_k'],
                                        vbytes)
    spent = trace.range_device_s.get(RANGE, 0.0)
    if not least or spent <= 0:
        return None
    return 100.0 * least / spent
