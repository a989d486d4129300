"""Bytes copied to the card a frame: the `bytes` of every tracker.upload
over the frames of every tracker.batch, over the window outside the
profiled stretch."""

from portbench.metrics._program import frames, window_spans


def read(rec):
    n = frames(rec)
    return sum(a["bytes"] for _t0, _t1, a in window_spans(rec, "tracker.upload")) / n if n else None
