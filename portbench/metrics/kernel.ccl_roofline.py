"""Kernel 2 (csrc/ccl.cu, labeling) at its share of the roofline over the
profiled stretch: bytes of each call's mask and labels (portbench's frozen
count) at 3.35 TB/s against the device time of the ccl_* kernels."""

from portbench.metrics._common import roofline

from portbench.roofline import work

SPANS = {"kernel.ccl": {"target": "caliscope_tpu_torch.detect.aruco:connected_components", "shapes": True}}


def read(rec):
    return roofline(rec, ["kernel.ccl"], ["ccl_rows", "ccl_cols", "ccl_resident"],
                    lambda shapes: work.ccl(*shapes[0], shapes[1]))
