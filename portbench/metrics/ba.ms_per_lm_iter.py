"""ms an LM iteration (solvers/bundle.py::_lm_run): the three BA stages'
seconds (progress labels) over the LM iterations their solves report in
`optimization_status`, over the window's jobs not profiled."""

from portbench.metrics._common import window_spans

SPANS = {"ba.optimize": {"target": "caliscope_tpu_torch.volume:CaptureVolume.optimize",
                         "keep": "optimization_status.iterations"}}
STAGES = ("Optimizing", "Robust refinement", "Re-optimizing")


def read(rec):
    jobs = [j for j in rec["jobs"] if not j["profiled"] and all(s in j["stages"] for s in STAGES)]
    iterations = sum(s[4] for s in window_spans(rec, "ba.optimize"))
    if not jobs or not iterations:
        return None
    return 1e3 * sum(sum(j["stages"][s] for s in STAGES) for j in jobs) / iterations
