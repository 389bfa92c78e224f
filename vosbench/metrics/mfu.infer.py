"""The floating-point operations of the frames of the traced video (the
reference network's convolutions and products at the cell's shapes, and
the readouts' similarity and value sums) over the window times the card's
dense bf16 peak, in percent."""

from vosbench.reference import work


def read(trace, run):
    inf = run.config['inference']
    flops = run.record.network_flops + work.readouts_flops(
        run.record.readouts, inf['key_dim'], inf['value_dim'], inf['top_k'])
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / (trace.window_s * work.H100_FLOPS['bfloat16'])
