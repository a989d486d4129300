"""Kernel 3 (csrc/corner_response.cu, the ring response) at its share of
the roofline over the profiled stretch: 133 float32 instructions a pixel
at 33.5 T/s, or 8 bytes a pixel at 3.35 TB/s, against the device time of
corner_response_kernel."""

from portbench.metrics._common import roofline

from portbench.roofline import work

SPANS = {"kernel.corner_response": {"target": "caliscope_tpu_torch.detect.corners:corner_response", "shapes": True}}


def read(rec):
    return roofline(rec, ["kernel.corner_response"], ["corner_response_kernel"],
                    lambda shapes: work.corner_response(*shapes[0]))
