"""Device-to-host flag reads an LM iteration: the ba.read spans over the
ba.lm_iter spans of the window's jobs not profiled (1 plus the PCG's
chunks, where the solve runs a PCG)."""

from portbench.metrics._program import per_lm_iter


def read(rec):
    return per_lm_iter(rec, len)
