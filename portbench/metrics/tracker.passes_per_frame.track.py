"""Passes of the tracker a frame: the frames of every tracker.pass (the
first orientation, the mirrored one, a full-resolution retry) over the
frames of every tracker.batch, over the window outside the profiled
stretch. 1.0 means no frame was tried twice."""

from portbench.metrics._program import frames, window_spans


def read(rec):
    n = frames(rec)
    return sum(a["frames"] for _t0, _t1, a in window_spans(rec, "tracker.pass")) / n if n else None
