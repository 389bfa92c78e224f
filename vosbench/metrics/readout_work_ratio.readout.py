"""The memory slots that the program's readouts read, over those that the
reference counts for the same video, in percent: the program's counter
readout.slot_rows (each readout's query rows times the slots of the stores
it reads, from the stores' host sizes; xmem2_tpu_torch/utils/profiling.py,
reset as each run_on_video call starts, so after the traced video it holds
that video's) over the sum of query rows times slots of the reference
record's readouts, which the cell's fixed schedule makes the same for every
video of the cell. 100 where the program reads every slot the reference
does and no more. None where the program keeps no such counter."""


def read(trace, run):
    from xmem2_tpu_torch.utils import profiling
    counters = getattr(profiling, 'counters', None)
    rows = counters().get('readout.slot_rows') if counters else None
    want = sum(r.p * r.n for r in run.record.readouts)
    if not rows or not want:
        return None
    return 100.0 * rows / want
