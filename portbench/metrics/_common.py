"""Helpers the metric readers share: spans of the window outside the
profiled stretch, and kernel roofline shares over the stretch."""

from __future__ import annotations

from portbench.roofline import work


def window_spans(rec, name):
    """Spans `name` inside the window and outside the profiled stretch."""
    a, b = rec["window"]
    return [s for s in rec["rec"].of(name, outside=rec["stretch"]) if s[2] >= a and s[3] <= b + 3600]


def stretch_spans(rec, name):
    a, b = rec["stretch"]
    return [s for s in rec["rec"].of(name) if s[2] >= a and s[3] <= b]


def roofline(rec, span_names, kernel_names, work_of):
    """Share (%) of the kernels' roofline over the profiled stretch: the
    calls recorded there (their argument shapes through `work_of`) against
    the device time of the GPU kernels named like `kernel_names`."""
    trace = rec["trace"]
    if trace is None or rec["device_name"] not in work.PEAKS:
        return None
    calls = [work_of(s[4]) for name in span_names for s in stretch_spans(rec, name)]
    seconds = sum(s for name, (_n, s) in trace.kernels.items() if any(k in name for k in kernel_names))
    return work.roofline_share(calls, seconds, rec["device_name"])
