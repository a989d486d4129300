"""The program's own spans (caliscope_tpu_torch.tracing) for the readers.

Importing this module turns the program's tracing on. The harness loads a
cell's readers only in a traced run, after set-up and before the window,
so the measured runs stay untraced and the traced window records the
spans.

Importing it also replaces `harness.Trace.__init__`, for the rest of the
process, by a wrapper that does two things before the harness's own
constructor runs. It adds the program's spans to the spans among which the
harness names an idle gap that no host event covers: the spans of the
thread that runs the profiler stand in its trace as record_function
ranges, but those of the other threads (the extraction's, the streamer's)
do not, as the profiler records only its own thread. And it drops the
device-side events flagged as user annotations: the profiler mirrors each
range on the device's timeline from its first kernel to its last, which is
no device work. Both belong in `harness.Trace` and `harness.profiled`
(a profiler over all threads, the flag's filter); this wrapper goes once
they are there.

A program without `caliscope_tpu_torch.tracing` has no spans: its readers
then return None.
"""

from __future__ import annotations

from types import SimpleNamespace

from portbench import harness

try:
    from caliscope_tpu_torch import tracing
except ImportError:
    tracing = None

if tracing is not None:
    from torch.autograd import DeviceType

    tracing.enable()
    _trace_init = harness.Trace.__init__

    def _with_program_spans(self, prof, wall_s, t_start, spans):
        program = [(s.name, s.thread_id, s.start_ns / 1e9, s.end_ns / 1e9, s.attrs) for s in tracing.spans()]
        events = [e for e in prof.events() if not (e.device_type == DeviceType.CUDA and getattr(e, "is_user_annotation", False))]
        _trace_init(self, SimpleNamespace(events=lambda: events), wall_s, t_start, list(spans) + program)

    harness.Trace.__init__ = _with_program_spans


def window_spans(rec, name):
    """The program's spans `name` of the requests (a tracker batch, a
    streamer frame or a calibration job, each with the spans under it)
    inside the window and outside the profiled stretch, as (start s, end s,
    attrs) on perf_counter's clock."""
    if tracing is None:
        return []
    (a, b), (sa, sb) = rec["window"], rec["stretch"]
    spans = tracing.spans()
    requests = set()
    for s in spans:
        t0, t1 = s.start_ns / 1e9, s.end_ns / 1e9
        if s.parent_id is None and t0 >= a and t1 <= b + 3600 and (t1 <= sa or t0 >= sb):
            requests.add(s.span_id)
    return [(s.start_ns / 1e9, s.end_ns / 1e9, s.attrs) for s in spans if s.name == name and s.request_id in requests]


def seconds(rec, *names):
    """Summed length of the window's spans of `names`."""
    return sum(t1 - t0 for name in names for t0, t1, _a in window_spans(rec, name))


def frames(rec):
    """Frames the tracker was given in the window (`tracker.batch`)."""
    return sum(a["frames"] for _t0, _t1, a in window_spans(rec, "tracker.batch"))


def ms_per_frame(rec, *names):
    """ms a frame in the spans of `names`, summed over threads."""
    n = frames(rec)
    return 1e3 * seconds(rec, *names) / n if n else None


def per_job(rec, *names):
    """Seconds a calibration job in the spans of `names`."""
    jobs = len(window_spans(rec, "calibrate.job"))
    return seconds(rec, *names) / jobs if jobs else None


def per_lm_iter(rec, value_of_reads):
    """value_of_reads(the window's `ba.read` spans) over its LM iterations."""
    iterations = len(window_spans(rec, "ba.lm_iter"))
    return value_of_reads(window_spans(rec, "ba.read")) / iterations if iterations else None
