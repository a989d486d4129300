"""ms a frame in the tracker's host assembly during playback (the
program's tracker.assemble spans, one frame a call), over the window
outside the profiled stretch."""

from portbench.metrics._program import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "tracker.assemble")
