"""Calibrate jobs: the production extrinsic calibration run back to back.

Each job is `caliscope_tpu_torch.pipelines.calibrate_extrinsics(image
points, cameras with intrinsics and without extrinsics, constraints)` on the
card, the cameras' intrinsics those of the scene, the observations the
scene's (gen/ring.py) from the seed. The window runs whole jobs and ends at
the first job end after `seconds`; `calibrate_s` is the completed jobs'
time over their count. One job drawn from the seed is judged
(reference/calibrate_check.py).

Traffic parameters: `constraints` ("board_truss": ConstraintSet.from_charuco
of the board whose inner corners the scene's grid is; "none"),
`filter_percentile` (the pipeline's default, 2.5).
"""

from __future__ import annotations

import time

import numpy as np

from portbench.gen.ring import ring_scene
from portbench.harness import profiled, resolve, sync
from portbench.reference import calibrate_check as CC

FILTER_TARGET = "caliscope_tpu_torch.volume:CaptureVolume.filter_by_percentile_error"


def make_scene(cell, seed):
    """The rig's scene (gen/ring.py) from the seed, with the board's spacing."""
    scene = ring_scene(cell.config, seed)
    scene["spacing"] = cell.config["board"]["spacing_m"]
    return scene


def setup(cell, seed, device):
    from caliscope_tpu_torch.cameras import CameraArray, CameraData
    from caliscope_tpu_torch.constraints import ConstraintSet
    from caliscope_tpu_torch.observations import ImagePoints
    from caliscope_tpu_torch.targets.charuco import Charuco

    cfg, traffic = cell.config, cell.traffic
    scene = make_scene(cell, seed)
    n = len(scene["sync"])
    ip = ImagePoints(
        scene["sync"].astype(np.int64), scene["cam"].astype(np.int64), np.zeros(n, np.int64),
        scene["kp"].astype(np.int64), scene["uv"], scene["obj_loc"], scene["sync"] / cfg["session"]["fps"],
    )
    cams = CameraArray({
        c: CameraData(cam_id=c, size=tuple(scene["size"]), matrix=scene["K"][c].copy(), distortions=scene["dist"][c].copy())
        for c in range(len(scene["K"]))
    })
    constraints = None
    if traffic["constraints"] == "board_truss":
        rows, cols = cfg["board"]["charuco_squares"]
        constraints = ConstraintSet.from_charuco(Charuco(rows=rows, columns=cols, square_size_m=scene["spacing"]))
    state = dict(cell=cell, scene=scene, ip=ip, cams=cams, constraints=constraints, device=device,
                 constrained=constraints is not None, jobs=[])
    _job(state)  # warm: every kernel built, every shape seen
    sync(device)
    return state


def _job(state, marks=None):
    """One calibration; returns (seconds, run, the volume its filter got)."""
    from caliscope_tpu_torch.pipelines import calibrate_extrinsics
    owner, attr = resolve(FILTER_TARGET)
    original = owner.__dict__[attr]
    given = []

    def filtered(volume, *args, **kwargs):
        given.append(volume)
        return original(volume, *args, **kwargs)

    def progress(pct, label):
        if marks is not None:
            marks.append((time.perf_counter(), label))

    setattr(owner, attr, filtered)
    try:
        t0 = time.perf_counter()
        run = calibrate_extrinsics(
            state["ip"], state["cams"], state["constraints"], device=state["device"], progress=progress,
            filter_percentile=state["cell"].traffic["filter_percentile"],
        )
        sync(state["device"])
        seconds = time.perf_counter() - t0
    finally:
        setattr(owner, attr, original)
    return seconds, run, given[-1] if given else None


def window(state, seconds, rec, trace):
    jobs, failed = [], 0
    rec.recording = True
    holder = {}
    t0 = time.perf_counter()
    while True:
        marks = []
        profile = trace and len(jobs) == 1 and "profile" not in holder
        try:
            if profile:
                a = time.perf_counter()
                with profiled(holder, state["device"]):
                    secs, run, before = _job(state, marks=marks)
                    rec.spans += _stage_spans(marks, a + secs)  # the pipeline's stages name the trace's gaps
                holder["stretch"] = (a, time.perf_counter())
            else:
                secs, run, before = _job(state, marks=marks)
            jobs.append(dict(seconds=secs, run=run, before=before, marks=marks, profiled=profile))
        except Exception as exc:  # a job that raises is a failed job, and the window goes on
            failed += 1
            print(f"portbench: a calibration raised {type(exc).__name__}: {exc}", flush=True)
        if time.perf_counter() - t0 >= seconds:
            break
    if trace and "profile" not in holder and jobs:
        a = time.perf_counter()
        marks = []
        with profiled(holder, state["device"]):
            secs = _job(state, marks=marks)[0]
            rec.spans += _stage_spans(marks, a + secs)
        holder["stretch"] = (a, time.perf_counter())
    rec.recording = False
    done = jobs
    for j in done:  # stage seconds from the pipeline's own progress labels
        m = j["marks"] + [(j["marks"][0][0] + j["seconds"], "end")] if j["marks"] else []
        j["stages"] = {a[1]: b[0] - a[0] for a, b in zip(m, m[1:])}

    state["jobs"] = done
    print(f"portbench: calibration seconds {[round(j['seconds'], 4) for j in done]}", flush=True)
    return dict(
        metrics={"calibrate_s": sum(j["seconds"] for j in done) / len(done) if done else float("nan")},
        attempted=len(done) + failed, failed=failed, jobs=done, profile=holder.get("profile"),
        window=(t0, t0 + seconds), stretch=holder.get("stretch", (t0, t0)),
    )


def _stage_spans(marks, end):
    """Spans of the pipeline's stages between its progress labels."""
    m = marks + [(end, "end")]
    return [(f"stage: {a[1]}", 0, a[0], b[0], None) for a, b in zip(m, m[1:])]


def answer(run, before):
    """The program's calibration as the check's plain arrays."""
    vol = run.capture_volume

    def cams_of(v):
        posed = v.camera_array.posed_cameras
        ids = sorted(posed)
        return np.stack([posed[c].rotation for c in ids]), np.stack([posed[c].translation for c in ids])

    def keys_of(v):
        wp, ip = v.world_points, v.image_points
        pk = np.stack([wp.sync_index, wp.object_id, wp.keypoint_id], 1).astype(np.int64)
        ok = np.stack([ip.sync_index, ip.cam_id, ip.object_id, ip.keypoint_id], 1).astype(np.int64)
        return pk, np.asarray(wp.xyz, float), ok, np.asarray(ip.img_xy, float)

    R, t = cams_of(vol)
    pk, xyz, ok, uv = keys_of(vol)
    R0, t0 = cams_of(before)
    pk0, xyz0, ok0, uv0 = keys_of(before)
    rig = vol.rigidity_report().rmse_mm if vol.constraints is not None else None
    first = CC.Answer(R0, t0, pk0, xyz0, ok0, uv0, float("nan"))
    return CC.Answer(R, t, pk, xyz, ok, uv, float(vol.reprojection_report.overall_rmse), rig, first)


def judge(state, res, seed):
    jobs = [j for j in res["jobs"] if not j["profiled"]] or res["jobs"]
    if not jobs:
        return {"jobs_judged": float("nan")}
    j = jobs[int(np.random.default_rng([seed, 3]).integers(len(jobs)))]
    cfg, traffic = state["cell"].config, state["cell"].traffic
    ans = answer(j["run"], j["before"])
    state["jobs"] = []  # the program's state is freed before the reference runs
    res["jobs"] = []
    return CC.judge(ans, state["scene"], state["constrained"], cfg["board"]["truss_sigma_m"],
                    traffic["filter_percentile"], seed)
