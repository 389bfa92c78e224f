"""Frames written in the window over its host seconds, from the first
call's start to the last call's end (the host's clock): the videos' rate
as a user of run_on_video waits on it. The host's speed moves it by 10-20%
between runs, so it stands here, without a bound, beside the card's
device_ms_per_frame."""


def read(trace, run):
    if not run.window_frames or run.window_s <= 0:
        return None
    return run.window_frames / run.window_s
