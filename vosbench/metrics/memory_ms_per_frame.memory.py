"""Self device milliseconds a frame of the memory stores: appends to
working and permanent memory and the consolidation into long-term memory
(the program's 'xmem.memory.' spans, Trace.spans); None where the program
opens no such span. In vos480-2obj, one consolidation a video, it reads
about a thousandth of device_ms_per_frame: a control there, which a cell
that fills memory over long videos brings to bear as a metric of its
own."""

SPANS = ('xmem.memory.',)


def read(trace, run):
    return trace.span_ms_per_frame(SPANS, run.frames)
