"""Kernel 1 (csrc/schur_s_rhs.cu, the Schur system) at its share of the
roofline over the profiled calibration: `schur_work(C, P)` operations at
67 TFLOP/s float32 against the device time of the s_rhs_* kernels."""

from portbench.metrics._common import roofline

from portbench.roofline import work

SPANS = {"kernel.schur": {"target": "caliscope_tpu_torch.solvers.bundle:schur_s_rhs", "shapes": True}}


def read(rec):
    # shapes: Jc (C, 2, 9, P), Jp, w, bp_t
    return roofline(rec, ["kernel.schur"], ["s_rhs_partial", "s_rhs_reduce"],
                    lambda shapes: work.schur_s_rhs(shapes[0][0], shapes[0][-1]))
