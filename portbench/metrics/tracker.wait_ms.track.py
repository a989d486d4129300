"""ms a frame waiting for the device program's packed output (the
program's tracker.readback spans: `out.cpu()`), summed over the
extraction's threads, over the window outside the profiled stretch."""

from portbench.metrics._program import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "tracker.readback")
