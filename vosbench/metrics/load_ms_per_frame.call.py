"""Self device milliseconds a frame of the call's set-up: the checkpoint's
load ('xmem.load', most of it the pageable upload of the weights to the
card) and the preload of the annotated frames ('xmem.preload'), which
every run_on_video call repeats. Read from the program's spans
(Trace.spans); None where the program opens no such span."""

SPANS = ('xmem.load', 'xmem.preload')


def read(trace, run):
    return trace.span_ms_per_frame(SPANS, run.frames)
