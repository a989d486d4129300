"""ms a frame that the streamer's pacing sleeps beyond what it asked for:
each streamer.pace span's length less its `requested_s`, summed over the
window outside the profiled stretch, over the frames tracked there (one
tracker.batch of one frame each)."""

from portbench.metrics._program import frames, window_spans


def read(rec):
    n = frames(rec)
    over = sum(t1 - t0 - a["requested_s"] for t0, t1, a in window_spans(rec, "streamer.pace"))
    return 1e3 * over / n if n else None
