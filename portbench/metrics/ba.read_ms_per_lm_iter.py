"""ms an LM iteration spends in the loop's device-to-host flag reads (the
program's ba.read spans: the LM loop's `bool(done)` and each PCG chunk's
`bool(running)`), over the ba.lm_iter spans of the window's jobs not
profiled."""

from portbench.metrics._program import per_lm_iter


def read(rec):
    return per_lm_iter(rec, lambda reads: 1e3 * sum(t1 - t0 for t0, t1, _a in reads))
