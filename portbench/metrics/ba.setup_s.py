"""Seconds a calibration spends setting up its three bundle adjustments
(the program's ba.setup spans: the problem's build in
CaptureVolume.optimize, its placement on the card and the plan in
lm_solve, up to the first LM iteration), over the window's jobs not
profiled."""

from portbench.metrics._program import per_job


def read(rec):
    return per_job(rec, "ba.setup")
