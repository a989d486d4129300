"""ms a frame spent reading it (FrameSource.next_frame), summed over the
extraction's threads, over the window outside the profiled stretch."""

from portbench.metrics._common import window_spans

SPANS = {"media.read": "caliscope_tpu_torch.media.video:FrameSource.next_frame"}


def read(rec):
    spans = window_spans(rec, "media.read")
    return 1e3 * sum(s[3] - s[2] for s in spans) / len(spans) if spans else None
