"""ms a frame waiting for the device program's packed output during
playback (the program's tracker.readback spans, one frame a call), over
the window outside the profiled stretch."""

from portbench.metrics._program import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "tracker.readback")
