"""Seconds a calibration spends in its three bundle adjustments
(volume.optimize: the linear, robust and final stages), from the
pipeline's own progress labels, over the window's jobs not profiled."""

STAGES = ("Optimizing", "Robust refinement", "Re-optimizing")


def read(rec):
    jobs = [j for j in rec["jobs"] if not j["profiled"] and all(s in j["stages"] for s in STAGES)]
    return sum(sum(j["stages"][s] for s in STAGES) for j in jobs) / len(jobs) if jobs else None
