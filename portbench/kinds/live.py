"""Live jobs: playback with tracking, as the GUI plays one camera's video
with the board overlay.

Set-up renders the rig's frames (gen/render.py) and writes camera
`camera`'s video to a temporary folder under TMPDIR, builds a
`CharucoTracker` on the card and tracks `warm_frames` of the frames once.
The window is `caliscope_tpu_torch.media.streamer.FramePacketStreamer` on
that video with `end_behavior='loop'`, paced by the streamer at the
traffic's `fps` (the capture rate), the tracker on the card, one frame a
dispatch; a subscriber takes every `TrackedFrame`. Open loop: frame g
(counted over the loops) is due at the play's start + g / fps, and the
window holds the frames due within `seconds`. Each one's latency runs from
its due time to its arrival at the subscriber; frames due in the window
that arrive after it are waited for, up to a minute. The streamer paces
itself by sleeping what is left of each frame's interval, so a slow frame
and each sleep's overshoot add lag that it never pays back: the lag grows
all through a run at 30 fps, the cell is above what the path sustains, and
its end-to-end metric is `live_fps`, the frames that arrived within the
window over its length; the 95th percentile of every due frame's latency
is kept for a reader (`lag_p95_ms`). A frame due in the window that never
arrives counts as failed.

Correct: every frame's corners against the renderer's exact projections
(reference/tracking_check.py), and `sample_count` calls of each of kernels
2-4, drawn from the seed, against the frozen plain copies.

Traffic parameters: `fps`, `camera`, `warm_frames`, `profile_frames`,
`sample_calls`, `sample_count`, `jitter_m`, `jitter_rad`.
"""

from __future__ import annotations

import math
import queue
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from portbench.gen.quicktime import write_gray
from portbench.gen.render import render_rig
from portbench.harness import profiled, resolve, sync
from portbench.kinds.track import _sampler, make_tracker
from portbench.reference import detect_plain, tracking_check

LATE_S = 60.0


def setup(cell, seed, device):
    cam = cell.traffic["camera"]
    frames, truth, visible, _drawn = render_rig(cell.config, cell.traffic, seed, device)
    host = frames[cam].cpu().numpy()
    del frames
    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    video = Path(tmp.name) / f"cam_{cam}.mp4"
    write_gray(video, host, cell.config["session"]["fps"])
    tracker = make_tracker(cell, device)
    for f in range(min(cell.traffic["warm_frames"], len(host))):  # warm: kernels built, B = 1 shapes seen
        tracker.get_points(host[f], cam)
    sync(device)
    return dict(cell=cell, device=device, tmp=tmp, video=video, tracker=tracker, truth=truth[cam:cam + 1],
                visible=visible[cam:cam + 1], n_frames=len(host), seed=seed, cam=cam)


def window(state, seconds, rec, trace):
    from caliscope_tpu_torch.media.streamer import FramePacketStreamer

    fps = state["cell"].traffic["fps"]
    profile_frames = state["cell"].traffic["profile_frames"]
    n_due = math.ceil(seconds * fps)  # frames 0 .. n_due - 1 are due within the window
    sampler = _sampler(state)
    saved = []
    for name, (target, _plain) in detect_plain.TARGETS.items():
        owner, attr = resolve(target)
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, sampler.wrap(name, getattr(owner, attr)))
    streamer = FramePacketStreamer(state["video"], cam_id=state["cam"], tracker=state["tracker"], end_behavior="loop",
                                   fps_override=fps)
    sub = streamer.subscribe()
    arrivals, holder = {}, {}
    start, stop = threading.Event(), threading.Event()
    profiler = threading.Thread(target=_profile_between, args=(start, stop, holder, state["device"], arrivals))
    if trace:
        profiler.start()
    last, loops = -1, 0
    try:
        sampler.on = rec.recording = True
        t0 = time.perf_counter()
        streamer.play()
        while True:
            try:
                item = sub.get(timeout=max(0.0, t0 + seconds + LATE_S - time.perf_counter()))
            except queue.Empty:
                break
            t = time.perf_counter()
            if item.frame_index <= last:
                loops += 1
            last = item.frame_index
            g = loops * state["n_frames"] + item.frame_index
            if g >= n_due:
                break
            arrivals[g] = (t, item)
            if trace and t >= t0 + seconds / 2:
                start.set()
                if "g0" in holder and g - holder["g0"] >= profile_frames:
                    stop.set()
    finally:
        start.set()
        stop.set()
        if trace:
            profiler.join()
        streamer.stop()
        sampler.on = rec.recording = False
        for owner, attr, original in saved:
            setattr(owner, attr, original)
    failed = n_due - len(arrivals)
    g = np.array(sorted(arrivals))
    t = np.array([arrivals[k][0] for k in g])
    latency = t - (t0 + g / fps)
    gaps = np.diff(t) if len(t) > 1 else np.array([np.nan])
    p95 = 1e3 * float(np.percentile(latency, 95)) if len(latency) else float("nan")
    print(f"portbench: live frames due {n_due}, arrived {len(arrivals)}; latency ms at 50/95/100 % "
          f"{np.round(1e3 * np.percentile(latency, [50, 95, 100]), 3).tolist() if len(latency) else []}", flush=True)
    state["sampler"], state["arrivals"] = sampler, {k: v[1] for k, v in arrivals.items()}
    return dict(
        metrics={"live_fps": float(np.sum(t <= t0 + seconds)) / seconds}, lag_p95_ms=p95,
        attempted=n_due, failed=failed, profile=holder.get("profile"), frames=len(arrivals),
        window=(t0, t0 + seconds), stretch=(holder.get("start", t0), holder.get("stop", t0)),
        profile_frames=holder.get("frames", 0), gaps=gaps,
    )


def _profile_between(start, stop, holder, device, arrivals):
    """torch.profiler from `start` to `stop`, on a thread of its own so that
    its set-up never holds up the subscriber."""
    start.wait()
    if stop.is_set():
        return
    with profiled(holder, device):
        holder["start"], holder["g0"] = time.perf_counter(), max(arrivals, default=0)
        stop.wait(LATE_S)
        holder["stop"], holder["frames"] = time.perf_counter(), max(arrivals, default=0) - holder["g0"]


def judge(state, res, seed):
    nums = {"kernel_mismatch": float(sum(state["sampler"].mismatch().values()))}
    if len(state["sampler"].kept) < len(detect_plain.TARGETS):
        nums["kernel_mismatch"] = float("nan")
    items = [state["arrivals"][g] for g in sorted(state["arrivals"])]
    state["tmp"].cleanup()
    if not items:
        return nums | {"pos_err_max_px": float("nan"), "stray": float("nan"), "err_p90_px": float("nan")}
    # every arrival is judged as a frame of its own against its video frame's truth
    fi = np.array([it.frame_index for it in items])
    a = np.concatenate([np.full(len(it.points.keypoint_id), i) for i, it in enumerate(items)])
    kp = np.concatenate([it.points.keypoint_id for it in items])
    uv = np.concatenate([np.asarray(it.points.img_loc, float).reshape(-1, 2) for it in items])
    n = tracking_check.corner_numbers(np.zeros(len(a), np.int64), a, kp, uv, state["truth"][:, fi],
                                      state["visible"][:, fi])
    return nums | n
