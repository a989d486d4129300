"""GPU kernels launched in the profiled stretch over the frames the
extraction reported in it."""


def read(rec):
    trace = rec["trace"]
    if trace is None or not rec["profile_frames"]:
        return None
    return trace.n_kernels / rec["profile_frames"]
