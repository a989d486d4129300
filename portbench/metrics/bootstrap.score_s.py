"""Seconds a calibration spends scoring the bootstrap's camera pairs (the
program's bootstrap.score span, inside bootstrap.pairs: the stereo
reprojection RMSE of every pair in one batched device pass), over the
window's jobs not profiled. A program that scores its pairs one call a
pair has no such span: there is nothing to read."""

from portbench.metrics._program import per_job, window_spans


def read(rec):
    if not window_spans(rec, "bootstrap.score"):
        return None
    return per_job(rec, "bootstrap.score")
