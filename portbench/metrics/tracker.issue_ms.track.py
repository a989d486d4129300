"""ms a frame issuing the tracker's device work: the program's spans
tracker.prepare (downsample, pack, pad), tracker.upload (the copy to the
card) and tracker.launch (the device program's launches) of
trackers/charuco_tracker.py::_run_stack_chunks, summed over the
extraction's threads, over the window outside the profiled stretch.

tracker.launch also holds the device program's own synchronisations and
device-to-host reads (186 stream synchronisations over a camera's 150
frames, ~39 chunks), so this time includes waits on the
card; tracker.wait_ms.track reads only the final copy back, which then
finds the card done."""

from portbench.metrics._program import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "tracker.prepare", "tracker.upload", "tracker.launch")
