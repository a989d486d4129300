"""Seconds a calibration spends in its percentile outlier filter (the
program's ba.filter span: CaptureVolume.filter_by_percentile_error), over
the window's jobs not profiled."""

from portbench.metrics._program import per_job


def read(rec):
    return per_job(rec, "ba.filter")
