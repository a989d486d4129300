"""The port's scripting API (caliscope_tpu_torch/api.py) against the JAX
package's on one small rendered recording: 2 cameras x 8 frames of
320x240 (seeded ChArUco views of tests/torch_detect_common.py, frame 3
without the board), written as uncompressed grey QuickTime by the
port's writer, which the JAX package reads through OpenCV (cv2).

extract_image_points (every third frame, which leaves the JAX package a
short last chunk to pad) and extract_image_points_multicam (every sync
index, and every fourth, there the port on one thread and on one a camera)
give the JAX package's rows: the same sync indices, cameras, ids, obj_loc
and frame times, img_xy within 2e-5 px (the detection slice's contract,
float32 on both sides). The port does not pad its last chunk; the rows show
it needs no padding. Plus the API's refusals and its exported names.
"""

from __future__ import annotations

import numpy as np
import pytest

from caliscope_tpu import api as JA
from caliscope_tpu.targets.charuco import Charuco as JaxCharuco
from caliscope_tpu.trackers.charuco_tracker import CharucoTracker as JaxTracker

from caliscope_tpu_torch import api as TA
from caliscope_tpu_torch.cameras import CameraData
from caliscope_tpu_torch.exceptions import CalibrationError
from caliscope_tpu_torch.media.video import write_gray_video
from caliscope_tpu_torch.observations import ImagePoints
from caliscope_tpu_torch.trackers import CharucoTracker
from torch_detect_common import QUAD_FRONT, board_frame, port_board
from torch_pose_common import one_torch_thread  # noqa: F401  (a fixture, used by name)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# a short last chunk (EXTRACT_BATCH is 16) in every run; frame 3, without the
# board, is read by the single and the every-frame runs, not by the every-fourth
N_FRAMES = 8
XY_ATOL = 2e-5
COLS = ("sync_index", "cam_id", "object_id", "keypoint_id", "obj_loc", "frame_time")


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec")
    jch = JaxCharuco(rows=5, columns=7, square_size_m=0.054)
    ch = port_board(jch)
    rng = np.random.default_rng(21)
    videos = {}
    for cid in (0, 1):
        frames = []
        for i in range(N_FRAMES):
            if i % 7 == 3:  # no board
                frames.append(np.clip(rng.normal(128, 2, (240, 320)), 0, 255).astype(np.uint8))
                continue
            quad = np.array(QUAD_FRONT) + rng.uniform(-8, 8, (4, 2))
            frames.append(board_frame(ch, quad, noise_seed=100 * cid + i)[0])
        videos[cid] = d / f"cam_{cid}.mp4"
        write_gray_video(videos[cid], frames)
    return jch, ch, videos


def _sorted(ip):
    order = np.lexsort((ip.keypoint_id, ip.object_id, ip.sync_index, ip.cam_id))
    return {c: getattr(ip, c)[order] for c in COLS + ("img_xy",)}


def _assert_same_rows(got, want):
    g, w = _sorted(got), _sorted(want)
    for c in COLS:
        np.testing.assert_array_equal(g[c], w[c], err_msg=c)
    assert np.abs(g["img_xy"] - w["img_xy"]).max() <= XY_ATOL


class _Recorder(TA.PlainProgress):
    def __init__(self):
        super().__init__()
        self.events = []

    def on_video_start(self, cam_id, total):
        self.events.append(("start", cam_id, total))

    def on_frame(self, cam_id, i, n):
        self.events.append(("frame", cam_id, i, n))

    def on_video_complete(self, cam_id):
        self.events.append(("done", cam_id))


def _one_thread(run):
    """run() with the multicam extraction's thread pool cut to one thread."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TA, "_MAX_THREADS", 1)
        return run()


@pytest.fixture(scope="module")
def runs(recording):
    """Each extraction once, module-wide: the port's CPU tracker takes
    ~0.4 s a frame on one thread."""
    jch, ch, videos = recording
    progress = _Recorder()
    return {
        # every third frame of camera 1: 3 frames, a short last chunk the JAX package pads
        "single": (
            TA.extract_image_points(videos[1], 1, CharucoTracker(ch, device="cpu"), frame_step=3, progress=progress),
            JA.extract_image_points(videos[1], 1, JaxTracker(jch), frame_step=3, progress=None),
            progress.events,
        ),
        "multicam": (
            TA.extract_image_points_multicam(videos, CharucoTracker(ch, device="cpu"), progress=None),
            JA.extract_image_points_multicam(videos, JaxTracker(jch), progress=None),
        ),
        "multicam_step4": (
            TA.extract_image_points_multicam(videos, CharucoTracker(ch, device="cpu"), frame_step=4, progress=None),
            JA.extract_image_points_multicam(videos, JaxTracker(jch), frame_step=4, progress=None),
            _one_thread(lambda: TA.extract_image_points_multicam(
                videos, CharucoTracker(ch, device="cpu"), frame_step=4, progress=None
            )),
        ),
    }


def test_extract_image_points_matches_jax(runs):
    got, want, events = runs["single"]
    _assert_same_rows(got, want)
    frames = set(range(0, N_FRAMES, 3)) - {3, 10}
    assert set(np.unique(got.sync_index).tolist()) == frames and len(got) == 24 * len(frames)
    np.testing.assert_array_equal(got.sync_index, want.sync_index)  # rows in frame order
    n = len(range(0, N_FRAMES, 3))
    assert events[0] == ("start", 1, n) and events[-1] == ("done", 1)
    assert [e[2] for e in events if e[0] == "frame"] == list(range(1, n + 1))


@pytest.mark.parametrize("run", ["multicam", "multicam_step4"])
def test_extract_image_points_multicam_matches_jax(runs, run):
    got, want, *one = runs[run]
    _assert_same_rows(got, want)
    step = 4 if one else 1
    assert set(np.unique(got.cam_id).tolist()) == {0, 1}
    assert len(np.unique(got.sync_index)) == len(set(range(0, N_FRAMES, step)) - {3, 10})
    # camera by camera in the mapping's order, whichever thread ends first
    assert np.all(np.diff(got.cam_id) >= 0)
    for other in one:  # one thread for both cameras: the same rows
        for c in COLS + ("img_xy",):
            np.testing.assert_array_equal(getattr(got, c), getattr(other, c))


def test_refusals(recording, tmp_path):
    _, ch, videos = recording
    tr = CharucoTracker(ch, device="cpu")
    with pytest.raises(ValueError, match="positive stride"):
        TA.extract_image_points(videos[0], 0, tr, frame_step=0, progress=None)
    with pytest.raises(FileNotFoundError):
        TA.extract_image_points(tmp_path / "none.mp4", 0, tr, progress=None)
    with pytest.raises(FileNotFoundError, match="cam 4"):
        TA.extract_image_points_multicam({0: videos[0], 4: tmp_path / "none.mp4"}, tr, progress=None)
    write_gray_video(tmp_path / "blank.mp4", [np.full((240, 320), 200, np.uint8)] * 3)
    with pytest.raises(CalibrationError, match="zero landmarks"):
        TA.extract_image_points(tmp_path / "blank.mp4", 0, tr, progress=None)
    markerless = ImagePoints(np.zeros(4), np.zeros(4), np.zeros(4), np.arange(4), np.ones((4, 2)))
    with pytest.raises(CalibrationError, match="obj_loc"):
        TA.calibrate_intrinsics(markerless, CameraData(0, (320, 240)), device="cpu")


def test_exported_surface_is_the_jax_packages():
    assert TA.__all__ == JA.__all__
    assert all(hasattr(TA, name) for name in TA.__all__)
    assert TA.EXTRACT_BATCH == JA.EXTRACT_BATCH == 16


@pytest.mark.cuda
def test_extraction_on_cuda_matches_cpu(recording):
    """The card's extraction of the recording (one thread a camera, kernels
    2-4) against the port's CPU run: the same rows, img_xy within 0.05 px
    (chip_smoke.py's bound for the card against the CPU)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, ch, videos = recording
    card = TA.extract_image_points_multicam(videos, CharucoTracker(ch), frame_step=4, progress=None)
    cpu = TA.extract_image_points_multicam(videos, CharucoTracker(ch, device="cpu"), frame_step=4, progress=None)
    for c in COLS:
        np.testing.assert_array_equal(getattr(card, c), getattr(cpu, c))
    assert np.abs(card.img_xy - cpu.img_xy).max() < 0.05
