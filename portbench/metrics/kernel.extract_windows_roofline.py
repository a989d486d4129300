"""Kernel 4 (csrc/extract_windows.cu, the window gather) at its share of
the roofline over the profiled stretch, both callers (the corner windows
and the marker atlas): each window read and written once at 3.35 TB/s
against the device time of the windows_* kernels."""

from portbench.metrics._common import roofline

from portbench.roofline import work

SPANS = {
    "kernel.windows.corners": {"target": "caliscope_tpu_torch.detect.corners:extract_windows", "shapes": True},
    "kernel.windows.atlas": {"target": "caliscope_tpu_torch.detect.kernels:extract_windows", "shapes": True},
}


def read(rec):
    # shapes: frames (B, Hp, Wp), yi (B, K), xi (B, K), win
    return roofline(rec, list(SPANS), ["windows_tma_kernel", "windows_rows_kernel"],
                    lambda shapes: work.extract_windows(shapes[0][0], shapes[1][1], shapes[3]))
