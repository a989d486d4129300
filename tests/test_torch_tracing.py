"""The port's in-program spans (caliscope_tpu_torch/tracing.py): the store
and its parents and requests, the profiler's view of them, the spans at the
tracker, streamer, pipeline and LM loop on small CPU inputs, and the
benchmark's readers of them (portbench/metrics/) on a synthetic record."""

from __future__ import annotations

import math
import threading
from collections import Counter, deque
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from caliscope_tpu_torch import tracing
from caliscope_tpu_torch.media.streamer import FramePacketStreamer
from caliscope_tpu_torch.media.video import write_gray_video
from caliscope_tpu_torch.pipelines import calibrate_extrinsics
from caliscope_tpu_torch.solvers.bundle import CG_CHECK_EVERY, BAConfig, lm_solve
from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics
from caliscope_tpu_torch.synthetic.factories import default_ring_scene
from caliscope_tpu_torch.targets.charuco import Charuco
from caliscope_tpu_torch.trackers import CharucoTracker
from torch_detect_common import QUAD_FRONT, board_frame

PORTBENCH = Path(__file__).resolve().parents[1] / "portbench"
STAGES = [
    "calibrate.preparing_cameras", "calibrate.bootstrapping_poses", "calibrate.reviewing_static_markers",
    "calibrate.optimizing", "calibrate.gating_intrinsic_refinement", "calibrate.robust_refinement",
    "calibrate.filtering_outliers", "calibrate.re-optimizing",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for the module: its CPU inputs are tiny,
    and under xdist's parallel workers a pool per worker spins against the
    others. The worker's setting is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tracing_off_after():
    yield
    tracing.disable()
    tracing.clear()


def traced(run):
    """The spans `run()` records, with tracing on only around it."""
    tracing.clear()
    tracing.enable()
    try:
        run()
    finally:
        tracing.disable()
    return tracing.spans()


def named(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing_and_hands_back_the_shared_noop():
    tracing.disable()
    tracing.clear()
    a, b = tracing.span("x", frames=3), tracing.span("y")
    assert a is b
    with a, b:
        pass
    assert tracing.spans() == [] and tracing.spans().dropped == 0


def test_parents_and_requests_on_two_threads():
    barrier = threading.Barrier(2)

    def request(tag):
        with tracing.span("root", tag=tag):
            barrier.wait()  # both roots open at once
            with tracing.span("child", tag=tag):
                with tracing.span("leaf", tag=tag):
                    pass
            with tracing.span("child", tag=tag):
                barrier.wait()

    def run():
        threads = [threading.Thread(target=request, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    spans = traced(run)
    assert len(spans) == 8
    by_id = {s.span_id: s for s in spans}
    for tag in "ab":
        mine = [s for s in spans if s.attrs == {"tag": tag}]
        (root,) = named(mine, "root")
        assert root.parent_id is None and root.request_id == root.span_id
        assert {s.request_id for s in mine} == {root.span_id}
        assert {s.thread_id for s in mine} == {root.thread_id}
        assert all(by_id[s.parent_id].name == "root" for s in named(mine, "child"))
        (leaf,) = named(mine, "leaf")
        assert by_id[leaf.parent_id].name == "child" and by_id[leaf.parent_id].attrs == {"tag": tag}
        for s in mine:
            assert s.start_ns <= s.end_ns
            if s.parent_id is not None:
                parent = by_id[s.parent_id]
                assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert len({s.request_id for s in spans}) == 2


def test_attributes_are_kept():
    def run():
        with tracing.span("tracker.upload", bytes=921_600, mirrored=True, scale=2.0):
            pass

    (s,) = traced(run)
    assert s.name == "tracker.upload" and s.attrs == {"bytes": 921_600, "mirrored": True, "scale": 2.0}


def test_the_bounded_store_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    tracing.clear()
    monkeypatch.setattr(tracing, "_store", deque(maxlen=3))
    tracing.enable()
    try:
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
        spans = tracing.spans()
    finally:
        tracing.disable()
    assert [s.name for s in spans] == ["s2", "s3", "s4"] and spans.dropped == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.spans().dropped == 0


def test_each_span_stands_in_the_profiler_as_a_host_event():
    from torch.profiler import ProfilerActivity, profile

    tracing.clear()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("ba.lm_iter"):
            torch.ones(4).sum()
            with tracing.span("ba.read"):
                bool(torch.ones(1) > 0)
    tracing.disable()
    host = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    assert {"ba.lm_iter", "ba.read"} <= host
    assert [s.name for s in tracing.spans()] == ["ba.read", "ba.lm_iter"]


def test_the_tracker_spans_its_passes_and_uploads():
    """A board frame and a blank one: the blank fails the first orientation
    and is tried mirrored, so one pass of 2 frames and one of 1."""
    board = Charuco(rows=5, columns=7, square_size_m=0.054)
    frame, _ = board_frame(board, QUAD_FRONT)
    stack = np.stack([frame, np.full_like(frame, 128)])
    tracker = CharucoTracker(board, device="cpu")
    spans = traced(lambda: tracker.get_points_batch(stack))
    (batch,) = named(spans, "tracker.batch")
    assert batch.attrs == {"frames": 2} and batch.parent_id is None
    assert {s.request_id for s in spans} == {batch.span_id}
    passes = named(spans, "tracker.pass")
    assert [p.attrs for p in passes] == [{"frames": 2, "mirrored": False, "scale": 1},
                                         {"frames": 1, "mirrored": True, "scale": 1}]
    assert all(p.parent_id == batch.span_id for p in passes)
    assert sum(s.attrs["bytes"] for s in named(spans, "tracker.upload")) == 3 * frame.nbytes
    counts = Counter(s.name for s in spans)
    # one device chunk a pass: prepare, upload, launch, readback, and two assemblies
    assert {n: counts[n] for n in ("tracker.prepare", "tracker.upload", "tracker.launch", "tracker.readback")} == \
        dict.fromkeys(("tracker.prepare", "tracker.upload", "tracker.launch", "tracker.readback"), 2)
    assert counts["tracker.assemble"] == 4
    assert tracker.dispatches == 2


@pytest.fixture(scope="module")
def calibration():
    """A tiny calibration traced: (its spans, its run)."""
    scene = default_ring_scene(3, 8)
    ip, cams = scene.image_points_noisy(), strip_extrinsics(scene.cameras)
    out = {}
    tracing.clear()
    tracing.enable()
    try:
        out["run"] = calibrate_extrinsics(ip, cams, None, device="cpu")
    finally:
        tracing.disable()
    spans = tracing.spans()
    tracing.clear()
    return spans, out["run"]


def test_a_calibration_spans_every_stage_under_one_request(calibration):
    spans, _run = calibration
    (job,) = named(spans, "calibrate.job")
    assert job.parent_id is None and {s.request_id for s in spans} == {job.span_id}
    stages = [s for s in spans if s.parent_id == job.span_id]
    assert [s.name for s in sorted(stages, key=lambda s: s.start_ns)] == STAGES
    by_id = {s.span_id: s for s in spans}

    def stage_of(s):
        while s.parent_id != job.span_id:
            s = by_id[s.parent_id]
        return s.name

    for name in ("bootstrap.pnp", "bootstrap.pairs", "bootstrap.triangulate"):
        assert [stage_of(s) for s in named(spans, name)] == ["calibrate.bootstrapping_poses"]
    # the pairs' scores: one batch inside bootstrap.pairs, one read for the 3 pairs
    (score,) = named(spans, "bootstrap.score")
    assert by_id[score.parent_id].name == "bootstrap.pairs"
    assert score.attrs["pairs"] == 3 and score.attrs["reads"] == 1 and score.attrs["points"] > 0
    assert [stage_of(s) for s in named(spans, "ba.filter")] == ["calibrate.filtering_outliers"]
    assert [stage_of(s) for s in named(spans, "ba.solve")] == [
        "calibrate.optimizing", "calibrate.robust_refinement", "calibrate.re-optimizing"]
    # a solve: set-up in optimize and in lm_solve, its iterations, the finish in both
    for solve in named(spans, "ba.solve"):
        kids = Counter(s.name for s in spans if s.parent_id == solve.span_id)
        assert kids["ba.setup"] == 2 and kids["ba.finish"] == 2 and kids["ba.lm_iter"] >= 1
    assert len(named(spans, "ba.read")) == len(named(spans, "ba.lm_iter"))  # dense Schur: one read an iteration


def test_lm_solve_spans_each_iteration_and_each_host_read(calibration, monkeypatch):
    _spans, run = calibration
    problem, cam9_0, X0 = run.capture_volume.ba_problem()
    reads = []
    to_bool = torch.Tensor.__bool__

    def counted(t):
        reads.append(1)
        return to_bool(t)

    monkeypatch.setattr(torch.Tensor, "__bool__", counted)
    out = {}
    spans = traced(lambda: out.setdefault("r", lm_solve(problem, cam9_0, X0, BAConfig(solver="cg", max_iter=3))))
    monkeypatch.undo()
    result = out["r"]
    iters, read_spans = named(spans, "ba.lm_iter"), named(spans, "ba.read")
    assert len(iters) == result.n_iterations == len(result.cg_iterations) >= 1
    assert len(read_spans) == len(reads)
    assert len(read_spans) == result.n_iterations + sum(max(1, math.ceil(k / CG_CHECK_EVERY))
                                                        for k in result.cg_iterations)
    assert {s.parent_id for s in read_spans} <= {s.span_id for s in iters}
    assert Counter(s.name for s in spans if s.parent_id is None) == {
        "ba.setup": 1, "ba.lm_iter": result.n_iterations, "ba.finish": 1}


def test_the_streamer_spans_its_frames_reads_and_pacing(tmp_path):
    fps, n = 50.0, 4
    video = tmp_path / "cam_0.mp4"
    write_gray_video(video, [np.full((16, 24), 40 * i, np.uint8) for i in range(n)], fps)

    def play():
        streamer = FramePacketStreamer(video, fps_override=fps)
        q = streamer.subscribe()
        streamer.play()
        got = []
        while (item := q.get(timeout=10)) is not None:
            got.append(item)
        streamer.stop()
        assert len(got) == n

    spans = traced(play)
    by_id = {s.span_id: s for s in spans}
    frames = named(spans, "streamer.frame")
    assert len(frames) == n + 1  # the last one reads the end of the stream
    assert all(f.parent_id is None for f in frames)
    for s in named(spans, "streamer.read"):
        assert by_id[s.parent_id].name == "streamer.frame"
    assert [by_id[s.parent_id].name for s in named(spans, "media.next_frame")] == ["streamer.read"] * (n + 1)
    pace = named(spans, "streamer.pace")
    assert 1 <= len(pace) <= n
    for s in pace:
        assert s.parent_id is None and 0 < s.attrs["requested_s"] <= 1 / fps


# ---- the benchmark's readers of the program's spans -----------------------

S = 1_000_000_000  # ns a second


def record_spans():
    """A window of [0, 10] s with the profiled stretch [4, 5]: two tracked
    chunks of 8 frames, two streamer sleeps and two calibration jobs
    outside the stretch; a chunk and a job inside it, and a chunk and a job
    that overlap it with spans of their own outside it (which no reader may
    count: a request is in or out whole)."""
    requests = [
        (("tracker.batch", 1.0, 2.0, {"frames": 8}), [
            ("tracker.prepare", 1.0, 1.01, {}), ("tracker.upload", 1.01, 1.03, {"bytes": 100}),
            ("tracker.launch", 1.03, 1.1, {}), ("tracker.readback", 1.1, 1.2, {}), ("tracker.assemble", 1.2, 1.5, {}),
            ("tracker.pass", 1.0, 1.9, {"frames": 8, "mirrored": False, "scale": 1}),
            ("tracker.pass", 1.9, 2.0, {"frames": 4, "mirrored": True, "scale": 1})]),
        (("tracker.batch", 6.0, 7.0, {"frames": 8}), [
            ("tracker.prepare", 6.0, 6.02, {}), ("tracker.upload", 6.02, 6.04, {"bytes": 300}),
            ("tracker.launch", 6.04, 6.1, {}), ("tracker.readback", 6.1, 6.3, {}), ("tracker.assemble", 6.3, 6.4, {}),
            ("tracker.pass", 6.0, 7.0, {"frames": 8, "mirrored": False, "scale": 1})]),
        (("tracker.batch", 4.2, 4.8, {"frames": 8}), [("tracker.upload", 4.3, 4.4, {"bytes": 1000})]),
        (("tracker.batch", 3.8, 4.3, {"frames": 8}), [("tracker.upload", 3.85, 3.9, {"bytes": 1000})]),
        (("streamer.pace", 2.0, 2.05, {"requested_s": 0.04}), []),
        (("streamer.pace", 7.0, 7.03, {"requested_s": 0.03}), []),
        (("calibrate.job", 0.5, 3.0, {}), [
            ("bootstrap.pnp", 0.6, 0.9, {}), ("bootstrap.pairs", 0.9, 1.4, {}),
            ("bootstrap.score", 1.2, 1.35, {"pairs": 28, "points": 588_000, "reads": 1}), ("ba.setup", 1.5, 1.6, {}),
            ("ba.setup", 1.7, 1.75, {}), ("ba.lm_iter", 2.0, 2.1, {}), ("ba.lm_iter", 2.1, 2.2, {}),
            *[("ba.read", t, t + 0.01, {}) for t in (2.05, 2.07, 2.15)], ("ba.filter", 2.5, 2.7, {})]),
        (("calibrate.job", 5.5, 9.5, {}), [
            ("bootstrap.pnp", 5.6, 5.8, {}), ("bootstrap.pairs", 5.8, 6.6, {}),
            ("bootstrap.score", 6.4, 6.45, {"pairs": 28, "points": 588_000, "reads": 1}), ("ba.setup", 6.6, 6.7, {}),
            ("ba.lm_iter", 7.0, 7.1, {}), ("ba.lm_iter", 7.1, 7.2, {}),
            *[("ba.read", t, t + 0.01, {}) for t in (7.05, 7.15, 7.17)], ("ba.filter", 8.0, 8.4, {})]),
        (("calibrate.job", 4.1, 4.9, {}), [("bootstrap.pnp", 4.2, 4.3, {}), ("bootstrap.score", 4.3, 4.4, {}),
                                           ("ba.lm_iter", 4.5, 4.6, {})]),
        (("calibrate.job", 3.2, 4.4, {}), [("bootstrap.pnp", 3.3, 3.6, {}), ("ba.read", 3.7, 3.8, {})]),
    ]
    out, ids = tracing.Spans(), iter(range(1, 1000))
    for (name, a, b, attrs), children in requests:
        root = next(ids)
        out.append(tracing.Span(name, root, None, root, 1, round(a * S), round(b * S), attrs))
        out += [tracing.Span(n, next(ids), root, root, 1, round(a * S), round(b * S), attrs)
                for n, a, b, attrs in children]
    return out


WANT = {
    "tracker.issue_ms.track": 1e3 * 0.2 / 16, "tracker.wait_ms.track": 1e3 * 0.3 / 16,
    "tracker.assemble_ms.track": 1e3 * 0.4 / 16, "tracker.passes_per_frame.track": 20 / 16,
    "tracker.h2d_bytes_per_frame.track": 400 / 16, "tracker.wait_ms.live": 1e3 * 0.3 / 16,
    "tracker.assemble_ms.live": 1e3 * 0.4 / 16, "streamer.oversleep_ms.live": 1e3 * 0.01 / 16,
    "bootstrap.pnp_s": 0.5 / 2, "bootstrap.pairs_s": 1.3 / 2, "bootstrap.score_s": 0.2 / 2, "ba.setup_s": 0.25 / 2,
    "ba.read_ms_per_lm_iter": 1e3 * 0.06 / 4, "ba.reads_per_lm_iter": 6 / 4, "filter.s": 0.6 / 2,
}


@pytest.fixture
def readers(monkeypatch):
    from portbench import harness
    from portbench.metrics import _program

    tracing.disable()  # importing _program turned it on
    monkeypatch.setattr(_program.tracing, "spans", record_spans)
    load = harness.Cell.metric_module.__get__(SimpleNamespace(here=PORTBENCH))
    return {name: load(name) for name in WANT}, _program


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_on_a_synthetic_record(readers, name):
    mods, _program = readers
    rec = {"window": (0.0, 10.0), "stretch": (4.0, 5.0)}
    assert mods[name].read(rec) == pytest.approx(WANT[name])
    assert isinstance(mods[name].read(rec), float)


def test_readers_find_nothing_in_a_program_without_spans(readers, monkeypatch):
    mods, _program = readers
    monkeypatch.setattr(_program, "tracing", None)
    rec = {"window": (0.0, 10.0), "stretch": (4.0, 5.0)}
    assert {name: mod.read(rec) for name, mod in mods.items()} == dict.fromkeys(WANT)


def test_the_score_reader_finds_nothing_where_pairs_are_scored_one_by_one(readers, monkeypatch):
    """A program whose bootstrap has no bootstrap.score span (it scores
    each pair in a call of its own) gives no bootstrap.score_s, not 0."""
    mods, _program = readers
    monkeypatch.setattr(_program.tracing, "spans", lambda: [s for s in record_spans() if s.name != "bootstrap.score"])
    rec = {"window": (0.0, 10.0), "stretch": (4.0, 5.0)}
    assert mods["bootstrap.score_s"].read(rec) is None
    assert mods["bootstrap.pairs_s"].read(rec) == pytest.approx(WANT["bootstrap.pairs_s"])


@dataclass
class Event:
    name: str
    device_type: DeviceType
    start: float  # us
    end: float
    is_user_annotation: bool = False

    @property
    def time_range(self):
        return SimpleNamespace(start=self.start, end=self.end)


def test_a_gap_no_host_event_covers_is_named_by_the_innermost_program_span(readers, monkeypatch):
    """Kernels at [0, 20] and [50, 60]; a host op over [20, 30] only: the
    gap [20, 50]'s middle (35 us, 15 us after the profiler's first host
    event) lies in a program span of another thread and a portbench span.
    The profiler's mirrors of program ranges on the device's timeline,
    flagged as user annotations, are no device time."""
    from portbench import harness

    _mods, _program = readers
    events = [Event("k", DeviceType.CUDA, 0, 20), Event("k", DeviceType.CUDA, 50, 60),
              Event("aten::copy_", DeviceType.CPU, 20, 30),
              Event("calibrate.job", DeviceType.CUDA, 0, 60, is_user_annotation=True),
              Event("tracker.assemble", DeviceType.CUDA, 10, 55, is_user_annotation=True)]
    program = tracing.Spans([tracing.Span("tracker.assemble", 1, None, 1, 7, 12_000, 18_000, {})])
    monkeypatch.setattr(_program.tracing, "spans", lambda: program)
    tr = harness.Trace(SimpleNamespace(events=lambda: events), 60e-6, 0.0, [("tracker.chunk", 1, 0.0, 1.0, None)])
    assert tr.idle_gaps == [["tracker.assemble", pytest.approx(30e-6)]]
    assert tr.busy_s == pytest.approx(30e-6) and set(tr.kernels) == {"k"}
