"""Seconds a calibration spends in the bootstrap's PnP (the program's
bootstrap.pnp span: solvers/pose_network.py's estimate_camera_object_poses,
on the card), over the window's jobs not profiled."""

from portbench.metrics._program import per_job


def read(rec):
    return per_job(rec, "bootstrap.pnp")
