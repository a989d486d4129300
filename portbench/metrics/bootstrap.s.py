"""Seconds a calibration spends bootstrapping poses (volume.bootstrap ->
solvers/pose_network.py), from the pipeline's own progress labels, over
the window's jobs that were not profiled."""

STAGE = "Bootstrapping poses"


def read(rec):
    jobs = [j for j in rec["jobs"] if not j["profiled"] and STAGE in j["stages"]]
    return sum(j["stages"][STAGE] for j in jobs) / len(jobs) if jobs else None
