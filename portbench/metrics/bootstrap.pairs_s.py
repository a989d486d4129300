"""Seconds a calibration spends on the bootstrap's camera pairs (the
program's bootstrap.pairs span: relative pose samples, outlier rejection,
the pairs' aggregation with their stereo scores, the network's bridge),
over the window's jobs not profiled."""

from portbench.metrics._program import per_job


def read(rec):
    return per_job(rec, "bootstrap.pairs")
