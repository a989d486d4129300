"""Percent of the profiled stretch in which no kernel, copy or set ran on
the card (torch.profiler's device events)."""


def read(rec):
    trace = rec["trace"]
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
