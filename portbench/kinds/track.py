"""Track jobs: the CLI / GUI `extract` step over the rig's videos.

Set-up renders each camera's frames on the device from the seed
(gen/render.py), writes them as grey QuickTime into a temporary folder
under TMPDIR, builds a `CharucoTracker` on the card and runs one warm pass.
A job is a pass of `caliscope_tpu_torch.api.extract_image_points_multicam`
over all cameras' videos (one thread a camera, chunks into
`get_points_batch`); the window repeats passes back to back (a closed
loop) and counts the frames that the extraction's own `on_frame` progress
reports within `seconds`; the pass running at the close finishes
uncounted. `track_fps` is those frames over the window.

Correct: every pass's corners against the renderer's exact projections
(reference/tracking_check.py), and `sample_count` calls of each of kernels 2-4,
drawn from the seed, against the frozen plain copies
(reference/detect_plain.py).

Traffic parameters: `jitter_m`, `jitter_rad` (the board poses' jitter from
the seed), `profile_frames` (frames in the traced run's profiled stretch),
`sample_calls` and `sample_count` (the check's calls of each kernel and
the calls they are drawn among).
"""

from __future__ import annotations

import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from portbench.gen.quicktime import write_gray
from portbench.gen.render import render_rig
from portbench.harness import profiled, resolve, sync
from portbench.reference import detect_plain, tracking_check


class Progress:
    """The extraction's progress callbacks, counting frames with their times."""

    def __init__(self):
        self.times = []
        self._lock = threading.Lock()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def on_info(self, message):
        pass

    def on_video_start(self, cam_id, total_frames):
        pass

    def on_frame(self, cam_id, frame_index, n_points):
        t = time.perf_counter()
        with self._lock:
            self.times.append(t)

    def on_video_complete(self, cam_id):
        pass

    def on_stage(self, pct, message):
        pass


def make_tracker(cell, device):
    from caliscope_tpu_torch.targets.charuco import Charuco
    from caliscope_tpu_torch.trackers import CharucoTracker

    b = cell.config["board"]
    return CharucoTracker(Charuco(rows=b["rows"], columns=b["columns"], square_size_m=b["square_m"]), device=device)


def setup(cell, seed, device):
    frames, truth, visible, _drawn = render_rig(cell.config, cell.traffic, seed, device)
    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    fps = cell.config["session"]["fps"]
    host = frames.cpu().numpy()
    del frames
    videos = {}
    for c in range(len(host)):
        videos[c] = Path(tmp.name) / f"cam_{c}.mp4"
        write_gray(videos[c], host[c], fps)
    del host
    tracker = make_tracker(cell, device)
    state = dict(cell=cell, device=device, tmp=tmp, videos=videos, tracker=tracker, truth=truth, visible=visible,
                 seed=seed)
    _pass(state, Progress())  # warm: kernels built, every chunk shape of the pass seen
    sync(device)
    return state


def _pass(state, progress):
    from caliscope_tpu_torch.api import extract_image_points_multicam

    return extract_image_points_multicam(state["videos"], state["tracker"], progress=progress)


def _sampler(state):
    """`sample_count` calls of each of kernels 2-4 to hold to the plain
    copies, drawn from the seed among the window's first `sample_calls`,
    which span a pass over the videos (a chunk of white frames gives a
    response of zeros in any precision, so one call is not enough)."""
    rng = np.random.default_rng([state["seed"], 5])
    n, k = state["cell"].traffic["sample_calls"], state["cell"].traffic["sample_count"]
    return detect_plain.Sampler({name: set(rng.choice(n, min(k, n), replace=False).tolist())
                                 for name in detect_plain.TARGETS})


def window(state, seconds, rec, trace):
    sampler = _sampler(state)
    saved = []
    for name, (target, _plain) in detect_plain.TARGETS.items():
        owner, attr = resolve(target)
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, sampler.wrap(name, getattr(owner, attr)))
    progress = Progress()
    passes, holder = [], {}
    profile_frames = state["cell"].traffic["profile_frames"]
    try:
        sampler.on = rec.recording = True
        t0 = time.perf_counter()
        if trace:
            _traced_window(state, seconds, rec, progress, passes, holder, profile_frames)
        else:
            while time.perf_counter() - t0 < seconds:
                passes.append(_pass(state, progress))
        sync(state["device"])
    finally:
        sampler.on = rec.recording = False
        for owner, attr, original in saved:
            setattr(owner, attr, original)
    times = np.asarray(progress.times)
    counted = int(np.sum(times <= t0 + seconds))
    stretch = holder.get("stretch", (t0, t0))
    state["sampler"] = sampler
    return dict(
        metrics={"track_fps": counted / seconds}, attempted=int(len(times)), failed=0, passes=passes,
        profile=holder.get("profile"), frames=counted, window=(t0, t0 + seconds),
        profile_frames=holder.get("frames", 0), stretch=stretch,
    )


def _traced_window(state, seconds, rec, progress, passes, holder, profile_frames):
    """Passes on a worker thread; the profiler over `profile_frames` frames
    from the middle of the window."""
    t0 = time.perf_counter()
    errors = []

    def work():
        try:
            while time.perf_counter() - t0 < seconds:
                passes.append(_pass(state, progress))
        except BaseException as exc:  # reported by the caller
            errors.append(exc)

    worker = threading.Thread(target=work)
    worker.start()
    time.sleep(seconds / 2)
    with profiled(holder, state["device"]):
        a = time.perf_counter()
        n0 = len(progress.times)
        while len(progress.times) - n0 < profile_frames and worker.is_alive():
            time.sleep(0.005)
        holder["frames"] = len(progress.times) - n0
        b = time.perf_counter()
    holder["stretch"] = (a, b)
    worker.join()
    if errors:
        raise errors[0]


def judge(state, res, seed):
    nums = {"kernel_mismatch": float(sum(state["sampler"].mismatch().values()))}
    if len(state["sampler"].kept) < len(detect_plain.TARGETS):
        nums["kernel_mismatch"] = float("nan")  # a target was never called
    worst = {}
    for ip in res["passes"]:
        n = tracking_check.corner_numbers(ip.cam_id, ip.sync_index, ip.keypoint_id, ip.img_xy, state["truth"],
                                          state["visible"])
        for k, v in n.items():
            worst[k] = max(worst.get(k, v), v) if k != "stray" else worst.get(k, 0.0) + v
    state["tmp"].cleanup()
    return nums | worst
