"""ms a frame inside CharucoTracker.get_points_batch (device program,
copies and host assembly), summed over the extraction's threads, over the
window outside the profiled stretch."""

from portbench.metrics._common import window_spans

SPANS = {"tracker.chunk": {"target": "caliscope_tpu_torch.trackers.charuco_tracker:CharucoTracker.get_points_batch",
                           "shapes": True}}


def read(rec):
    spans = window_spans(rec, "tracker.chunk")
    frames = sum(s[4][0][0] for s in spans)
    return 1e3 * sum(s[3] - s[2] for s in spans) / frames if frames else None
