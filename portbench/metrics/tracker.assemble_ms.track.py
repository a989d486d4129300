"""ms a frame in the tracker's host assembly (the program's
tracker.assemble spans: unpacking and marker decode a chunk, then the
per-frame board fit, snap and gates), summed over the extraction's
threads, over the window outside the profiled stretch."""

from portbench.metrics._program import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "tracker.assemble")
