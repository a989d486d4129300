#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (caliscope_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and the
repository checkout beside this file; it exits non-zero without them and
on any failed check. Phases:

1. Versions, and the card's name and power limit as nvidia-smi reports them.
2. Build all four kernels of the port and its nvJPEG shim from the
   checkout's sources (one nvcc process each, started together, into
   caliscope_tpu_torch/_build/).
3. Kernel phases: each kernel against its plain PyTorch version on the card,
   at the main paths' shapes (and ragged ones), with its times (CUDA
   events, median of warm repetitions), a one-call PyTorch yardstick where
   one call computes the function, and the least time the card could take
   for the same work. The Schur kernel's S must be exactly symmetric and
   the same bits on a second run; kernels 2-4 must equal their plain
   versions bit for bit (torch.equal); the labeling cases say which of its
   two paths each took and must cover both and every cluster size, and so
   do the window gather's (TMA and rows; tma_launches grows on the TMA
   path only), with the host's time a call at its callers' shapes; every
   kernel reports its device time by GPU kernel under torch.profiler.
4. Detection slice: 16 rendered 1280x720 views of a 5x7 ChArUco board (the
   recipe of bench.py's detection workload, warped in numpy) through
   CharucoTracker.get_points_batch on the card — corners found, accuracy
   against the known homographies, a repeated call, the card's result
   against the port's own CPU result on two frames, the kernels' launch
   counts per device-program dispatch (every window gather on the TMA
   path), wall time and a profile.
5. BA slice: the canonical eight-camera bundle-adjustment problem
   (8 cameras, 35,000 points, 141,422 observations, 0.5 px noise; the
   recipe of bench.py, perturbed initial translations) through
   CaptureVolume on the card — linear BA, robust BA with intrinsics, 2.5 %
   percentile filter, final BA — with the kernel's launch count, the
   kernel-less Schur path's final cost, and the recovered rig against the
   truth.
6. Pipeline: the extrinsic calibration flow a user runs, cameras with
   intrinsics and no extrinsics to a calibrated rig, through
   caliscope_tpu_torch.pipelines.calibrate_extrinsics on the card — an
   8-camera ring watching a 5x7 board for 600 frames (the port's synthetic
   engine, default_ring_scene(8, 600): 168,000 observations, 21,000 points),
   PnP bootstrap, linear / robust / final BA with the Schur kernel and the
   percentile filter — gated on all cameras posed by the bootstrap, final
   RMSE, the rig against the truth, and kernel launches equal to the Schur
   solves; the bootstrap's device time, host time and device->host
   synchronisations; the PnP batch (float32 on the card) against a float64
   run; and a 4-camera x 20-frame run on the card against the port's own
   CPU run.
7. Constrained and sparse pipelines: the production ChArUco flow, cameras
   with intrinsics and no extrinsics through calibrate_extrinsics with a
   ConstraintSet on the card, three runs at 8 cameras x 600 frames —
   (a) default_ring_scene with the board truss, (b) two_sided_ring_scene
   with ConstraintSet.from_charuco (cross-face ties active), (c)
   ring_with_static_markers(8, 600, 3) with the truss and the static marker
   squares, on the sparse row layout — each gated on all cameras posed,
   final RMSE < 1 px, 0.5 deg / 5 mm to the truth, rigidity < 2 mm ((a),
   (b)) or no static marker dropped ((c)), and no Schur kernel launch (its
   gate is closed for constrained and sparse problems). Per run: stage wall
   seconds, LM and CG iterations per BA stage, and for the final BA stage
   repeated its device->host synchronisations and device time. Also: one LM
   iteration of (c)'s problem in the row-major and the obs-minor layout and
   the layout 'auto' takes; 'cg' and 'schur_cg' on the canonical BA problem
   against the 'schur' optimum; whether a repeated constrained solve gives
   the same bits; and a small two-sided run on the card against the port's
   CPU run.
8. Intrinsics and the other trackers: (a) run_intrinsic_calibration on the
   card for 8 cameras of 1920x1080 (six Brown, two fisheye) with 600
   candidate frames each, gated on the JAX suite's bounds against the truth
   (1 % focal, 8 px principal point, k1, RMSE < 1 px), on the (default,
   float64) solve against a float32 one and, for one camera, on the card
   against the port's CPU run; the solves' own seconds; one camera's J in
   closed form against torch.func.jacfwd, timed; (a') an
   orientation-starved camera whose selection falls back to all 120
   candidates (F, J's bytes, peak memory, seconds); (b) 48 rendered
   1280x720 ChArUco frames through CharucoTracker on the card and then
   run_intrinsic_calibration, gated on K_TRUE and on the kernels' launches
   per dispatch; (c) ChessboardTracker and ArucoTracker, one 1280x720 frame
   a call, 16 frames each, gated on complete grids / every id, corner
   accuracy, the card against the CPU, the launches per frame and, at the
   recipe's full tilt, the JAX package's corners a view; kernel 4 held to
   its plain version (torch.equal) at every shape (b) and (c) gave it (the
   calls recorded as they launch); and kernels 2-4 against their plain
   versions at the trackers' shapes (B = 1; K = 512, win 28), timed there.
9. Vertical and sharded: (a) GeoCalib's tiny perspective-field network with
   seeded random weights, exported at 320x576 and run through
   OnnxTorchSession against the module's forward (ms a call of each), then
   its up head seeded to a constant field and the vertical estimator's
   frames path (resize on the card, the network, a gravity fit a frame) on
   8 cameras x 6 frames of 1920x1080, gated on every camera's up within
   1 deg of +y; (b) fit_gravity on 8 analytic up-fields with 10 % outlier
   pixels, gated on the truth (0.5 deg) and on the port's CPU fit (1e-3
   deg), float32 and float64 timed with their LM iterations; (c) the
   canonical BA problem (dense, 40,960 bucketed points) for 10 LM
   iterations on one placement, over a world-size-1 NCCL mesh and over two
   processes that share the card through gloo (`--sharded-worker`), gated
   on the same iterations, the cost (1e-5), and, up to the similarity the
   BA leaves free, the rotations (1e-4 rad), the intrinsic columns (1e-4 of
   their scale) and the centers (0.05 mm) against the single placement, and
   as they are every cam9 entry (1e-2 of its column's scale) and the
   centers (1 mm), the two ranks equal bit for bit, kernel 1 launched once
   a Schur solve on each rank and held to its plain version on each rank's
   first LM iteration's blocks (P = 20,480); ms per LM iteration and the
   all-reduces and bytes per iteration.
10. Baked: BAConfig(bake_problem=True), the LM iteration captured as CUDA
   graphs and cached on the problem (caliscope_tpu_torch/solvers/baked.py).
   The canonical BA problem (dense, 40,960 bucketed points, kernel 1 inside
   the head graph) to convergence baked and unbaked from the same start,
   gated on the same LM iterations and convergence, every cam9 and X entry
   within 1e-5 of its column's scale (whether they are bit-equal printed),
   kernel 1's launches = the baked solve's Schur solves (counted per
   replay), and a second baked solve replaying the cached graphs with no
   new capture; ms per LM iteration baked and unbaked (CUDA events, median
   of 3 fixed 10-iteration solves each, in turns), the capture's ms, the
   graphs' pool MiB, host reads an iteration, device ms and GPU kernels an
   iteration under the profiler; 'cg' and 'schur_cg' on the canonical
   problem and the constrained static-marker problem of 7 (c) (sparse rows,
   'schur' with its CG), each gated on the same LM and CG iterations baked
   and unbaked; a world-size-1 NCCL mesh, baked against unbaked bit for bit
   with the all-reduces counted per replay; and a gloo world on the card,
   where a baked solve must raise ValueError.
11. Workspace: a user's project folder, from recordings to a calibrated rig
   and a reconstruction, through the port's CLI in process
   (caliscope_tpu_torch.__main__.main: init, export-board, status,
   calibrate-intrinsics, extract, calibrate-extrinsics, reconstruct,
   status). The JAX suite's end-to-end recipe (tests/test_workspace_e2e.py)
   at 1280x720: 4 cameras in a ring, 30 intrinsic and 96 extrinsic frames
   each and a 32-frame recording of a moving board, rendered in numpy (in
   spawned processes) and written as uncompressed grey QuickTime cam_N.mp4
   files by the port's writer. Gated on every frame decoding to the frame
   written and the containers' size, rate and count; each camera's
   intrinsic RMSE < 1 px and focal within 3 %; more than 500 observations
   from every camera; extrinsic RMSE < 1 px, camera centres within 2 cm
   and scale within 3 % after a similarity; every workflow step COMPLETE;
   the capture volume reloading with its RMSE; the recording's board
   corners within 1 cm (median) and its CSV and TRC; kernels 2-4 launched
   as many times as the trackers dispatched (one thread a camera), kernel 1
   not at all (the ChArUco truss closes its gate); multicamera extraction
   with 1 and 4 threads giving the same rows; the playback streamer
   tracking every frame of the recording; the card within 0.05 px of the
   port's CPU run on camera 0's first 16 extrinsic frames with the board.
   Prints seconds a
   step, decode MB/s and frames/s a camera, extraction frames/s, the
   device's idle share during `extract`, launches a step, peak memory.
12. GUI: the same recordings, copied into a fresh project folder, through
   the port's GUI (caliscope_tpu_torch.gui.main_window.MainWindow on the
   headless Qt backend, device cuda), driven as a user clicks it: the
   Project tab's board and routing, the Cameras tab's Calibrate for each
   camera (frame skip 1, as the CLI step ran; the display queue and its
   FrameRenderThread live, the undistortion preview on with the CLI run's
   camera), the Extract tab, the Extrinsics tab's Calibrate, the
   Reconstruct tab on the recording, the Explorer tab's default preset.
   Gated on the workspace phase's bounds for the GUI's own files, every
   step COMPLETE in the Project tab's step strip, the files the GUI wrote
   (camera_array.toml, the intrinsic reports, the extraction CSV, the
   capture volume, the recording's exports) equal byte for byte to the
   CLI's, kernels 2-4 launched as many times as the trackers dispatched and
   equal to their plain versions at every input, kernel 1 launched as many
   times as the Schur solves (none: the Extrinsics tab's truss closes its
   gate and the Explorer's 'auto' solves its small presets densely) and
   held to its plain version on the Explorer bootstrap's first LM
   iteration's blocks, the undistortion preview within one grey level of
   the CPU's, at least one frame displayed a camera and no error on the
   render thread, and non-empty playback, coverage and lens-model images.
   Prints seconds a GUI action, extraction frames/s with the display thread
   on against the CLI's, the device's idle share, frames displayed and
   dropped, peak memory.
13. Decode: compressed recordings on the card. (a) NVDEC's answer
   (cuvidGetDecoderCaps) for H.264, MPEG-4 Part 2, HEVC and JPEG at 8-bit
   4:2:0; (b) the committed clips under tests/data/video/: the MJPEG board
   clip through nvJPEG against the port's numpy decoder (within 2 grey
   levels, GRAY; BGR reported) and the tracker's corners on both (99 % of
   them found within 0.05 px), the mp4v clip through NVDEC against OpenCV's
   frames (2 grey levels, the same frames when decoded from the sync
   samples alone) or, where the caps refuse MPEG-4, FrameSource raising
   with their answer; (c) the workspace phase's extrinsic videos (4 cameras
   x 96 frames of 1280x720) written again as lossless I_PCM H.264 and as
   MJPEG (quality 100), gated on every H.264 luma plane NVDEC gives back
   equal to the luma written, or, where the caps refuse H.264, on
   FrameSource and the extraction raising with their answer; on the MJPEG
   frames within 2 grey levels of the raw ones; and on
   api.extract_image_points_multicam over the compressed copies against
   the same call on the raw videos (99 % of its rows found within 0.05 px;
   the distances' median, 99th percentile and largest printed),
   kernels 2-4 launched as dispatched and equal to their plain versions at
   every input. Prints decode frames/s and MB/s a camera, extraction
   frames/s, the device's idle share and peak memory.
14. A `kernels` JSON line (each kernel with its launches on every path,
   `launches_by_path`), then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Each slice's launch counts are set to 0 just before it is driven and read
just after; launches made to compare or time a kernel do not count.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_CAMERAS = 8
N_POINTS = 35_000
N_OBS = 141_422
SEED = 7
NOISE_PX = 0.5
TRANSLATION_NOISE_M = 0.02
LAM = 1e-3

# Kernel vs plain version on the card, float32: the TPU's compiled-kernel
# test used rtol = atol = 1e-3 (sums of ~40k f32 terms in another order).
KERNEL_RTOL = KERNEL_ATOL = 1e-3
# Kernel vs plain version on the blocks of the canonical problem's first LM
# iteration, whose columns span orders of magnitude: each difference is
# scaled by the entry's Cauchy-Schwarz bound (sqrt(S_ii S_jj) for S, and
# alike for rhs and Hpp^-1), so 1e-4 is relative to the entry's own scale;
# two f32 summation orders over ~40k points differ by far less, a wrong
# term by O(1).
BLOCK_RTOL = 1e-4
# The kernel and kernel-less Schur paths must reach the same optimum; they
# accumulate in different orders, so trajectories drift at f32 roundoff
# (observed relative gaps 8e-8 and 3e-7 on the H100).
SOLVE_COST_RTOL = 1e-5
MAX_FINAL_RMSE_PX = 1.0
MAX_CENTER_ERROR_M = 0.005

# The detection workload: bench.py's (16 frames of 1280x720 uint8, a 5x7
# DICT_4X4_50 board at 100 px per square, outline jittered +-40 px, rng 3).
DETECT_BATCH = 16
DETECT_WH = (1280, 720)
DETECT_BASE_QUAD = ((200, 90), (1080, 120), (1040, 620), (240, 600))
MIN_FOUND_FRACTION = 0.9
MAX_CORNER_ERROR_PX, MAX_MEAN_CORNER_ERROR_PX = 0.6, 0.3
# the card's packets against the port's CPU packets on the same frames
# (float sums in another order; the CPU tests hold 0.02 px against JAX)
GPU_VS_CPU_ATOL_PX = 0.05

# The pipeline workload: default_ring_scene(8, 600) — an 8-camera ring at
# r = 2 m, 1920x1080, f = 1400 px, a 5x7 grid board on an orbit, 0.5 px
# noise, seed 42; 600 frames are 20 s of one recording at 30 fps. Its gates
# are the JAX package's headline contract (tests/synthetic/
# test_production_pipeline.py: 0.5 deg / 5 mm per camera against the truth
# after Umeyama on the camera centers), and the card's 4 x 20 run within
# 0.05 deg / 1 mm of the port's CPU run (float32 against float64 BA).
PIPE_SCENE = (8, 600)
PIPE_SMALL = (4, 20)
PIPE_BUCKET = 24_576  # bucket_size(21,000 points + 1, fine=True)
MAX_PIPE_ROTATION_DEG = 0.5
MAX_PIPE_CENTER_M = 0.005
CARD_VS_CPU_ROTATION_DEG = 0.05
CARD_VS_CPU_CENTER_M = 0.001
# the float32 PnP batch (the port's, on the card) against float64: a group
# classified the other way, or a DLT gone wrong, parts by degrees; roundoff
# by ~1e-4 deg (3.6e-4 measured at 8 x 600)
PNP_F32_MAX_GAP_DEG = 0.01

# The constrained and sparse pipelines, 8 cameras x 600 frames each, on the
# JAX package's production contract (0.5 deg / 5 mm, the 2 mm rigidity
# limit RIGIDITY_TOL_MM of tests/synthetic/test_production_pipeline.py).
CONSTRAINED_SCENE = (8, 600)
N_STATIC_MARKERS = 3
MAX_RIGIDITY_MM = 2.0
# 'cg' and 'schur_cg' against the 'schur' optimum of the canonical problem
SOLVER_COST_RTOL = 1e-5
# LM iterations timed per layout on the static-marker problem
LAYOUT_TIMING_ITERS = 5

# The intrinsic phase. (a) Intrinsics from observations: 8 cameras of
# 1920x1080 — six Brown (default_ring_scene's webcam truth, f = 1400 px) and
# two fisheye (tests/test_intrinsics.py's fisheye truth scaled to 1080p) —
# each with 600 candidate frames (20 s at 30 fps of one intrinsic
# recording) of a 5x7 inner-corner board at 54 mm posed by the JAX suite's
# recipe (random axis, tilt 0.1-0.9 rad, lateral offsets, depth 0.4-1.2 m;
# corners outside the frame dropped), 0.5 px noise, numpy seed INTR_SEED;
# run_intrinsic_calibration at its defaults (30 target frames, soft_l1 at
# 1 px). Gates: the JAX suite's bounds (tests/test_intrinsics.py:87-92,
# 149-150).
INTR_WH = (1920, 1080)
INTR_CANDIDATES = 600
INTR_N_BROWN, INTR_N_FISHEYE = 6, 2
INTR_FISHEYE_K = ((930.0, 0.0, 960.0), (0.0, 927.0, 540.0), (0.0, 0.0, 1.0))  # (620, 618, 640, 360) x 1.5
INTR_FISHEYE_DIST = (0.08, -0.02, 0.005, -0.001)
INTR_NOISE_PX = 0.5
INTR_SEED = 17
FOCAL_RTOL, PP_ATOL_PX, MAX_INTR_RMSE_PX = 0.01, 8.0, 1.0
K1_ATOL = {False: 0.02, True: 0.03}  # Brown, fisheye
# The solve runs in float64 by default, on the card too (float32 never
# meets the LM's stop test and runs to its cap; solvers/intrinsics.py). A
# float32 solve of the same input against it, bound stated before the
# first run on the card: K's entries within 1e-3 relative, distortion
# within 5e-3; and one camera's card result against the port's CPU run to
# the same bounds.
F32_K_RTOL, F32_DIST_ATOL = 1e-3, 5e-3
# (a') an orientation-starved camera: 120 candidates all tilted about the
# board's x axis (0.3-0.6 rad), two orientation bins of the selector's
# eight (lens distortion and lateral offsets spread one tilt direction over
# two), so the selection falls back to every candidate.
STARVED_CANDIDATES = 120
# (b) intrinsics from 48 rendered 1280x720 ChArUco frames through the
# pinhole K_TRUE (no distortion), posed by the same recipe.
FRAMES_FOR_INTRINSICS = 48
K_TRUE = ((1000.0, 0.0, 642.0), (0.0, 995.0, 358.0), (0.0, 0.0, 1.0))
# (c) the other trackers, one 1280x720 frame a call: a 6x8-square
# chessboard (60 px squares) and three DICT_4X4_50 markers, 16 frames each,
# posed through K_TRUE. The chessboard views keep to a tilt of 0.2 rad: the
# reference's lattice ordering completes the grid under moderate
# perspective only (ROADMAP.md section 3). The recipe's full tilt range is
# run too, held to the CPU view for view and to the corners the JAX
# package's tracker gives on the same views (CHESS_WIDE_CORNERS, held to it
# in tests/test_torch_trackers_other.py).
TRACKER_FRAMES = 16
CHESS_TILT = (0.0, 0.2)
CHESS_WIDE_SEED = INTR_SEED + 4
CHESS_WIDE_CORNERS = (35, 35, 35, 0, 0, 35, 35, 0, 35, 35, 35, 35, 0, 35, 35, 35)
MARKER_IDS = (3, 17, 44)

# Peaks of the card the bounds are computed for, keyed by
# torch.cuda.get_device_name(): bytes/s and non-tensor FP32 operations/s
# (the H100 SXM's data-sheet rates at its full 700 W power limit; an FMA
# counts as two operations), and FP32 instructions/s where no FMA may be
# formed (132 SMs x 128 lanes x 1.98 GHz: one operation a lane a clock).
# markerless phase: (a) the pipeline scene without obj_loc, (a') the card
# against the CPU on a small ring; (b) observations dropped in runs; (c)
# RTMPose-m Halpe26 (its model card: 26 keypoints, 256 x 192, SimCC); (d)
# the blob chain (the JAX suite's surrogate, tests/test_onnx_engine.py)
MARKERLESS_SMALL = (4, 25)
DROP_FRACTION = 0.05
MAX_RECON_MEDIAN_M = 0.005
POSE_VARIANT, POSE_CARD = "m", "rtmpose_m_halpe26.toml"
POSE_ATOL, POSE_RTOL = 2e-3, 1e-3  # tests/test_rtmpose_arch.py:69-70
POSE_FRAMES = 32
CHAIN_CAMERAS, CHAIN_FRAMES = 4, 80
CHAIN_MODEL_HW = (128, 160)
MAX_CHAIN_MEDIAN_M = 0.02  # tests/test_onnx_engine.py:256
EPIPOLAR_PARTS = ("pooled_correspondences", "recover_pair_pose", "_assemble_from_scaffold", "stereo_rmse_batch")
# vertical and sharded phase: (a) GeoCalib tiny at the 16:9 geometry (short
# side 320, edges multiples of 32), 8 cameras x 6 frames of 1920x1080 (the
# JAX package's n_sample_frames); (b) analytic up-fields at the network's
# field size; (c) the canonical BA problem on one placement, a world-size-1
# NCCL mesh and two gloo ranks sharing the card
VERT_HW = (320, 576)
VERT_CAMERAS, VERT_FRAMES = 8, 6
VERT_FRAME_WH = (1920, 1080)
MAX_UP_DEG = 1.0
FIT_STRIDE, FIT_NOISE, FIT_OUTLIERS = 8, 0.01, 0.10
MAX_FIT_DEG = 0.5
CARD_VS_CPU_FIT_DEG = 1e-3
SHARD_WORLD = 2
SHARD_ITERS = 10
# against the single placement, up to the similarity the BA leaves free
# (no camera is fixed): in float32 two reduction orders drift apart along
# that gauge over the iterations (on an NVIDIA H100 80GB HBM3 at 700 W,
# 4.9e-5 m of the centers as they are and 7.3e-4 of a cam9 column's scale,
# PERF.md) while the cost agrees to 7e-8. The raw bounds, set from those
# readings, still fail a rig that drifts far along the gauge.
SHARD_COST_RTOL = 1e-5
SHARD_CAM9_RTOL = 1e-4  # rotations (rad) and the intrinsic columns over their scale
SHARD_CENTER_M = 5e-5
SHARD_RAW_CAM9_RTOL = 1e-2  # every cam9 entry as it is, over its column's scale
SHARD_RAW_CENTER_M = 1e-3  # the centers as they are
SHARD_TIMEOUT_S = 300

PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12, 33.5e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def _project(X, R, t, K, dist):
    import numpy as np

    xc = X @ R.T + t
    xn = xc[:, :2] / xc[:, 2:3]
    k1, k2, p1, p2, k3 = dist
    r2 = np.sum(xn**2, axis=1)
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    x, y = xn[:, 0], xn[:, 1]
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd * K[0, 0] + K[0, 2], yd * K[1, 1] + K[1, 2]], axis=1)


def synth_rig(n_cameras=N_CAMERAS, n_points=N_POINTS, n_obs=N_OBS, seed=SEED):
    """The canonical session of bench.py: an 8-camera ring 3 m out, points in
    a 2 m cube, unique (camera, point) pairs, 0.5 px noise — plus perturbed
    initial translations. Returns (truth, start) camera dicts and the
    observations (cam_idx, pt_idx, uv) and true points."""
    import numpy as np

    rng = np.random.default_rng(seed)
    K = np.array([[900.0, 0, 640], [0, 900.0, 360], [0, 0, 1]])
    dist = np.array([0.1, -0.05, 0.001, -0.001, 0.01])
    Rs, ts = [], []
    for i in range(n_cameras):
        a = 2 * np.pi * i / n_cameras
        c = np.array([3.0 * np.cos(a), 3.0 * np.sin(a), 1.2])
        z = -c / np.linalg.norm(c)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z], axis=0)
        Rs.append(R)
        ts.append(-R @ c)
    X = rng.uniform([-1, -1, -0.5], [1, 1, 1.5], size=(n_points, 3))
    pair = rng.choice(n_points * n_cameras, size=n_obs, replace=False)
    cam_idx = (pair % n_cameras).astype(np.int64)
    pt_idx = (pair // n_cameras).astype(np.int64)
    uv = np.empty((n_obs, 2))
    for i in range(n_cameras):
        m = cam_idx == i
        uv[m] = _project(X[pt_idx[m]], Rs[i], ts[i], K, dist)
    uv = uv + rng.normal(scale=NOISE_PX, size=uv.shape)
    t_start = [t + rng.normal(scale=TRANSLATION_NOISE_M, size=3) for t in ts]

    def cams(translations):
        return {
            i: dict(matrix=K, distortions=dist, rotation=Rs[i], translation=translations[i],
                    size=(1280, 720), fisheye=False)
            for i in range(n_cameras)
        }

    return cams(ts), cams(t_start), cam_idx, pt_idx, uv, X


def umeyama_center_error(truth, est):
    """RMS distance (m) between camera centers after the best similarity
    alignment of `est` onto `truth` (the BA gauge is free)."""
    import numpy as np

    mu_t, mu_e = truth.mean(0), est.mean(0)
    T, E = truth - mu_t, est - mu_e
    U, S, Vt = np.linalg.svd(T.T @ E / len(truth))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / np.mean(np.sum(E**2, 1))
    aligned = s * E @ R.T + mu_t
    return float(np.sqrt(np.mean(np.sum((aligned - truth) ** 2, 1))))


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps=20, rounds=5):
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    by CUDA events, after a warm-up call."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / reps)
    return statistics.median(samples)


def schur_work(C, P):
    """(bytes, flops) schur_s_rhs must move and do: each input read once,
    each output written once; products and sums of G, Y, S, rhs and the
    point inverses. S is symmetric, so only its upper triangle counts."""
    n_cp = 9 * C
    bytes_ = 4 * (C * 2 * 9 * P + C * 2 * 3 * P + C * 2 * P + 3 * P + 1 + n_cp * n_cp + n_cp + 9 * P)
    flops = P * (
        C * 2 * 15 + 40  # point blocks and their inverse
        + n_cp * 2 * (1 + 3 * 2)  # G_k
        + 3 * n_cp * 3 * 2  # Y_k
        + 3 * n_cp * (n_cp + 1)  # S, upper triangle
        + 3 * n_cp * 2  # rhs
    )
    return bytes_, flops


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def kernel_phase(device, peaks):
    import numpy as np
    import torch

    from caliscope_tpu_torch.kernel_times import device_ms_by_kernel
    from caliscope_tpu_torch.solvers import fused_schur as FS

    def inputs(C, P, seed, lam=LAM):
        rng = np.random.default_rng(seed)
        Jc = rng.normal(size=(C, 2, 9, P)).astype(np.float32) * 0.1
        Jp = rng.normal(size=(C, 2, 3, P)).astype(np.float32) * 0.1
        w = rng.uniform(0.5, 1.0, size=(C, 2, P)).astype(np.float32)
        bp = rng.normal(size=(3, P)).astype(np.float32)
        pin = min(7, P - 1)
        w[:, :, pin] = 0.0  # one unobserved point: the pinned branch
        Jp[:, :, :, pin] = 0.0
        t = [torch.from_numpy(a).to(device) for a in (Jc, Jp, w, bp)]
        return t + [torch.tensor([lam], dtype=torch.float32, device=device)]

    results = {}
    # the BA slice's shape (C = 8, P = bucket_size(35001, fine=True)), the
    # pipeline's (C = 8, P = bucket_size(21001, fine=True)), a ragged point
    # count, the camera bound, a camera count that is no multiple of 8
    # (padded tile rows), fewer points than one tile, and the BA slice's
    # points split over SHARD_WORLD ranks (a gloo rank's shard in the
    # vertical and sharded phase). With
    # one camera every point block has rank 2 and its damped inverse is of
    # order 1 / lam, which magnifies float32 roundoff by as much: lam = 1 there
    shapes = ((N_CAMERAS, 40_960), (N_CAMERAS, PIPE_BUCKET), (N_CAMERAS, 12_345), (FS.MAX_CAMERAS, 4_099), (5, 1_000), (1, 7),
              (N_CAMERAS, 40_960 // SHARD_WORLD))
    for C, P in shapes:
        args = inputs(C, P, seed=C * 100_000 + P, lam=1.0 if C == 1 else LAM)
        got = FS.schur_s_rhs(*args)
        again = FS.schur_s_rhs(*args)
        want = FS.schur_s_rhs_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got[0], got[0].T):
            raise AssertionError(f"schur_s_rhs C={C} P={P}: S is not exactly symmetric")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"schur_s_rhs C={C} P={P}: two runs on the same inputs gave different bits")
        err = 0.0
        for name, g, w_ in zip(("S", "rhs", "Hpp_inv"), got, want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"schur_s_rhs C={C} P={P}: non-finite {name}")
            bad = (g - w_).abs() > KERNEL_ATOL + KERNEL_RTOL * w_.abs()
            if bad.any():
                raise AssertionError(
                    f"schur_s_rhs C={C} P={P}: {name} disagrees with the plain version at "
                    f"{int(bad.sum())} entries (max |diff| {float((g - w_).abs().max()):.3e})"
                )
            err = max(err, float((g - w_).abs().max()))
        log(
            f"kernel schur_s_rhs C={C} P={P}: matches plain (max |diff| {err:.3e}, rtol=atol={KERNEL_RTOL}), "
            "S exactly symmetric, two runs bit-equal"
        )
        results[(C, P)] = (args, err)

    args, err = results[(N_CAMERAS, 40_960)]
    C, P = N_CAMERAS, 40_960
    n_cp = 9 * C
    launches_before = FS.schur_s_rhs.launches
    ms = time_ms(lambda: FS.schur_s_rhs(*args))
    plain_ms = time_ms(lambda: FS.schur_s_rhs_plain(*args))
    passes = device_ms_by_kernel(lambda: FS.schur_s_rhs(*args))
    FS.schur_s_rhs.launches = launches_before  # timing launches are not the main path's
    log(f"kernel schur_s_rhs C={C} P={P}: device time by pass (torch.profiler, ms per launch, launches per call) {json.dumps(passes)}")
    # yardstick: the (72, 3P) x (3P, 72) product that carries most of the
    # FLOPs, one torch.matmul (no single PyTorch call computes the function)
    A = torch.randn(n_cp, 3 * P, device=device)
    B = torch.randn(3 * P, n_cp, device=device)
    library_ms = time_ms(lambda: torch.matmul(A, B))
    bytes_, flops = schur_work(C, P)
    mem_rate, f32_rate, _ = peaks
    t_bytes, t_ops = bytes_ / mem_rate * 1e3, flops / f32_rate * 1e3
    entry = {
        "name": "schur_s_rhs",
        "route": "cuda",
        "source": "caliscope_tpu_torch/csrc/schur_s_rhs.cu",
        "replaces": "caliscope_tpu/solvers/pallas_schur.py:146",
        "launches": None,  # filled from the slice phase
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "device_ms_by_pass": {name: rec["ms"] for name, rec in passes.items()},
    }
    log(
        f"kernel schur_s_rhs C={C} P={P}: {ms:.4f} ms by CUDA events around the wrapper (plain {plain_ms:.4f} ms, one (72,3P)x(3P,72) "
        f"torch.matmul {library_ms:.4f} ms); needs {bytes_ / 1e6:.1f} MB and {flops / 1e9:.3f} GFLOP -> "
        f"bound {entry['bound_ms'] * 1e3:.1f} us by {entry['bound_by']}"
    )
    # the same numbers at the pipeline's shape
    args, err = results[(N_CAMERAS, PIPE_BUCKET)]
    launches_before = FS.schur_s_rhs.launches
    ms = time_ms(lambda: FS.schur_s_rhs(*args))
    plain_ms = time_ms(lambda: FS.schur_s_rhs_plain(*args))
    passes = device_ms_by_kernel(lambda: FS.schur_s_rhs(*args))
    FS.schur_s_rhs.launches = launches_before
    A, B = A[:, : 3 * PIPE_BUCKET].contiguous(), B[: 3 * PIPE_BUCKET].contiguous()
    library_ms = time_ms(lambda: torch.matmul(A, B))
    bytes_, flops = schur_work(N_CAMERAS, PIPE_BUCKET)
    t_bytes, t_ops = bytes_ / mem_rate * 1e3, flops / f32_rate * 1e3
    entry["at_pipeline_shape"] = {
        "C": N_CAMERAS, "P": PIPE_BUCKET, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "device_ms_by_pass": {name: rec["ms"] for name, rec in passes.items()},
    }
    log(f"kernel schur_s_rhs at the pipeline's shape: {json.dumps(entry['at_pipeline_shape'])}")
    return entry



# ---------------------------------------------------------------------------
# Detection: data, kernel phases, slice
# ---------------------------------------------------------------------------


def detect_frames(n=DETECT_BATCH):
    """(board, frames (n, 720, 1280) uint8, true corner positions per frame)."""
    import numpy as np

    from caliscope_tpu_torch.targets import render
    from caliscope_tpu_torch.targets.charuco import Charuco

    ch = Charuco(rows=5, columns=7, square_size_m=0.054)
    board = ch.board_image(px_per_square=100, margin_squares=0.5)
    corners = render.board_corner_pixels(ch, 100, 0.5)
    rng = np.random.default_rng(3)
    frames, truths = [], []
    for _ in range(n):
        dst = np.array(DETECT_BASE_QUAD, np.float64) + rng.uniform(-40, 40, size=(4, 2))
        frame, H = render.board_view(board, dst, DETECT_WH)
        frames.append(frame)
        truths.append(render.project(H, corners))
    return ch, np.stack(frames), truths


def bound_entry(name, source, replaces, err, ms, plain_ms, library_ms, bytes_, ops, peaks, what, op_rate=None):
    """A `kernels` entry with the bound computed from this run's bytes and
    operations (at `op_rate`, by default the FP32 peak), and its arithmetic
    logged."""
    mem_rate, f32_rate = peaks[0], op_rate or peaks[1]
    t_bytes, t_ops = bytes_ / mem_rate * 1e3, ops / f32_rate * 1e3
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": None,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms,
    }
    lib = "none (no single PyTorch call computes it)" if library_ms is None else f"{library_ms:.4f} ms"
    log(
        f"kernel {name} {what}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library call {lib}); needs "
        f"{bytes_ / 1e6:.2f} MB -> {t_bytes * 1e3:.2f} us at {mem_rate / 1e12:.2f} TB/s, {ops / 1e9:.4f} G operations -> "
        f"{t_ops * 1e3:.2f} us at {f32_rate / 1e12:.1f} T/s; bound {entry['bound_ms'] * 1e3:.2f} us by {entry['bound_by']}, "
        f"the kernel at {100 * entry['bound_ms'] / ms:.1f} % of it"
    )
    return entry


def response_ops_per_pixel():
    """(operations a pixel, of them for the 16 samples) of the ring response:
    each vertical blend formed once per column (it serves two neighbouring
    outputs); a term with a weight of exactly 0 costs nothing, one of
    exactly 1 no product, so a blend of two terms costs 3 (2 products + 1
    sum), of one term 1 or 0; then 16 differences + 16 sums for sr and dr,
    16 sums and a product for the mean, 3 for mr and 3 for the result."""
    from caliscope_tpu_torch.detect import cuda_kernels as CK

    _, tap_weights = CK.ring_taps()

    def blend_ops(w0, w1):
        terms = [w for w in (w0, w1) if w != 0.0]
        return sum(w != 1.0 for w in terms) + len(terms) - 1

    tap_ops = sum(blend_ops(wy0, wy1) + blend_ops(wx0, wx1) for wy0, wy1, wx0, wx1 in tap_weights.tolist())
    return tap_ops + 32 + 17 + 6, tap_ops


def detect_kernel_phase(device, peaks, frames):
    """Kernels 2-4 against their plain versions on the card, and their
    times at the detection path's shapes. Returns their `kernels` entries."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from caliscope_tpu_torch.detect import ccl as CCL
    from caliscope_tpu_torch.detect import cuda_kernels as CK
    from caliscope_tpu_torch.detect import kernels as DK
    from caliscope_tpu_torch.kernel_times import device_ms_by_kernel
    from caliscope_tpu_torch.trackers.charuco_tracker import _RUN_CHUNK

    rng = np.random.default_rng(5)
    on_card = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    counts = (CCL.connected_components.launches, CCL.connected_components.resident_launches,
              CK.corner_response.launches, CK.extract_windows.launches, CK.extract_windows.tma_launches)
    imgs = on_card(frames[:_RUN_CHUNK]).to(torch.float32)  # one dispatch's frames
    B, H, W = imgs.shape

    # ---- kernel 2: labeling. Masks: the port's own threshold of the frames
    # (what the path labels), random masks, and ragged shapes.
    integral = DK.integral_image(imgs)
    board_mask = (DK.adaptive_threshold(imgs, 10, 7.0, integral) | DK.adaptive_threshold(imgs, 26, 7.0, integral)).contiguous()
    del integral
    cases = [("threshold of the frames", board_mask, (4,)), ("random 45 %", on_card(rng.uniform(size=(B, H, W)) < 0.45), (4,))]
    for shape, p in (((2, 70, 130), 0.55), ((1, 40, 136), 0.35)):
        cases.append((f"random {shape}", on_card(rng.uniform(size=shape) < p), (0, 1, 4, 12)))
    cases.append(("threshold crop (2,70,130)", board_mask[:2, 300:370, 500:630].contiguous(), (1, 4, 12)))

    def hooked(shape, p):
        """Dense, with a hook down column 0, along the last row and up column
        2, whose minimum arrives at the bottom of column 2 in round 2 and has
        to climb it (upwards through bands that are foreground throughout,
        as label 0 runs down column 0 through them); column 6 is cut once,
        column 9 and one row are foreground throughout."""
        m = rng.uniform(size=shape) < p
        m[:, :, :12] = False
        m[:, :, 0] = m[:, -1, :3] = m[:, 5:, 2] = True
        m[:, :, 6] = m[:, :, 9] = True
        m[:, shape[1] // 2, 6] = False
        m[:, shape[1] // 3, 20:] = True
        return on_card(m)

    # the resident path at every cluster size, with trailing blocks short
    # (226 rows in 16 x 15) and empty (225 rows), a width that is no multiple
    # of 4, and bands of 901 rows
    for shape, p in (((2, 45, 1280), 0.5), ((1, 90, 1280), 0.6), ((1, 180, 1270), 0.45), ((1, 224, 2048), 0.5),
                     ((2, 225, 2048), 0.6), ((1, 226, 2047), 0.9), ((2, 720, 1280), 0.9), ((2, 3601, 33), 0.97)):
        cases.append((f"hooked {shape}", hooked(shape, p), (1, 4, 12)))
    # frames that fit no cluster: wider than the resident path takes, and
    # taller than the rows of a column strip the two-launch kernel stages at
    # once (two segments of a strip, and three); and 1080p, where the plain
    # version's offsets need more than int32 (it takes them in int64)
    for shape, p in (((1, 2160, 448), 0.9), ((1, 2200, 440), 0.97), ((1, 40, 2100), 0.5), ((1, 3601, 300), 0.97),
                     ((2, 1080, 1920), 0.45)):
        cases.append((f"hooked {shape}", hooked(shape, p), (1, 4, 12)))

    paths = set()
    for what, mask, iters in cases:
        plan = CCL.resident_plan(*mask.shape[1:])
        if plan is None:
            segments = -(-mask.shape[1] // CCL.MAX_SEGMENT_ROWS)
            path = f"two launches a round, column strips in {segments} segment{'s' * (segments > 1)}"
            paths.add(("segments", min(segments, 3)))
        else:
            path = f"resident, {plan[0]} blocks x {plan[1]} rows"
            paths.add(plan[0])
        for n_iters in iters:
            before = (CCL.connected_components.launches, CCL.connected_components.resident_launches)
            got = CCL.connected_components(mask, n_iters)
            want = CCL.connected_components_plain(mask, n_iters)
            torch.cuda.synchronize()
            took = (CCL.connected_components.launches - before[0], CCL.connected_components.resident_launches - before[1])
            if took != (1, int(plan is not None)):
                raise AssertionError(f"ccl {what}: counted {took} (launches, resident) for the plan {plan}")
            if got.dtype != torch.int32 or not torch.equal(got, want):
                raise AssertionError(
                    f"ccl {what} {tuple(mask.shape)} n_iters={n_iters} ({path}): {int((got != want).sum())} labels differ from the plain version"
                )
        log(f"kernel ccl {what} {tuple(mask.shape)} n_iters={list(iters)} [{path}]: labels equal the plain version's")
    if paths != {("segments", 1), ("segments", 2), ("segments", 3), *CCL.CLUSTER_SIZES}:
        raise AssertionError(f"ccl: the cases took the paths {paths}, not one, two and more segments and every cluster size")
    plan = CCL.resident_plan(H, W)
    log(
        f"kernel ccl: a {H}x{W} frame takes a cluster of {plan[0]} blocks x {plan[1]} rows, {CCL.resident_bytes(plan[1], W)} bytes of "
        f"shared memory a block; cudaOccupancyMaxActiveClusters = {CCL.resident_max_active_clusters(H, W)}"
    )
    ccl_passes = device_ms_by_kernel(lambda: CCL.connected_components(board_mask, 4))
    log(f"kernel ccl ({B},{H},{W}) n_iters=4: device time by GPU kernel (torch.profiler, ms per launch, launches per call) {json.dumps(ccl_passes)}")
    ccl_entry = bound_entry(
        "ccl", "caliscope_tpu_torch/csrc/ccl.cu", "caliscope_tpu/detect/pallas_ccl.py:99", 0.0,
        time_ms(lambda: CCL.connected_components(board_mask, 4)),
        time_ms(lambda: CCL.connected_components_plain(board_mask, 4), reps=3, rounds=3), None,
        # mask read once (1 B/px), labels written once (4 B/px); per pixel and
        # round two min-or-keep steps (one per pass), counted at the FP32
        # lanes' rate (the data sheet gives no integer rate; bytes bound it
        # by two orders of magnitude either way)
        B * H * W * 5, B * H * W * 2 * 4, peaks, f"({B},{H},{W}) bool, n_iters=4",
    )
    ccl_entry["device_ms_by_pass"] = {name: rec["ms"] for name, rec in ccl_passes.items()}

    # ---- kernel 3: ring response. The kernel does the plain version's
    # single IEEE float32 operations in its order (dropping only terms with
    # weights of exactly 0 or 1), so the two must be equal: the frames, a
    # ragged shape, frames smaller than one 128 x 32 tile (and than the
    # border), and a frame mostly of zeros of either sign
    zeros = rng.normal(scale=40.0, size=(2, 96, 160)).astype(np.float32)
    zeros[:, 8:60, 10:90] = 0.0
    zeros[:, 40:90, 60:150] = -0.0
    zeros[:, ::5, :] = 0.0
    for what, x in (("frames", imgs), ("random (2,97,131)", on_card(rng.uniform(0, 255, size=(2, 97, 131)).astype(np.float32))),
                    ("below one tile (3,20,100)", on_card(rng.uniform(0, 255, size=(3, 20, 100)).astype(np.float32))),
                    ("below the border (1,12,40)", on_card(rng.uniform(0, 255, size=(1, 12, 40)).astype(np.float32))),
                    ("zero-heavy (2,96,160)", on_card(zeros))):
        got, want = CK.corner_response(x), CK.corner_response_plain(x)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all() or not torch.equal(got, want):
            raise AssertionError(f"corner_response {what}: {int((got != want).sum())} responses differ from the plain version's "
                                 f"(max |diff| {float((got - want).abs().max()):.3e})")
        log(f"kernel corner_response {what} {tuple(x.shape)}: equal to the plain version (torch.equal), max response {float(want.max()):.1f}")
    ops_px, tap_ops = response_ops_per_pixel()
    log(f"kernel corner_response: {tap_ops} operations a pixel for the 16 samples, {ops_px} in all, each one FP32 "
        f"instruction (no FMA may be formed): {peaks[2] / 1e12:.1f} T/s, not the {peaks[1] / 1e12:.0f} TFLOP/s FMA peak")
    resp_passes = device_ms_by_kernel(lambda: CK.corner_response(imgs))
    log(f"kernel corner_response ({B},{H},{W}): device time by GPU kernel (torch.profiler, ms per launch, launches per call) {json.dumps(resp_passes)}")
    resp_entry = bound_entry(
        "corner_response", "caliscope_tpu_torch/csrc/corner_response.cu", "caliscope_tpu/detect/pallas_kernels.py:94", 0.0,
        time_ms(lambda: CK.corner_response(imgs)), time_ms(lambda: CK.corner_response_plain(imgs), reps=3, rounds=3), None,
        B * H * W * 8, B * H * W * ops_px, peaks, f"({B},{H},{W}) f32", op_rate=peaks[2],
    )
    resp_entry["device_ms"] = sum(rec["ms"] for rec in resp_passes.values())

    # ---- kernel 4: windows, on both paths of the kernel: at both callers'
    # shapes and the chessboard's (K = 512 at B = 1), an odd K (TMA); a
    # ragged frame, win 17, a frame of Wp % 4 != 0 (a 1366-wide frame padded
    # by 14, as the subpixel stage pads) and an unaligned base (rows). Seeds:
    # random, every clip corner, and a few outside the frame, which both
    # versions clamp. The path each shape took is the rule's, and
    # tma_launches grows on the TMA path only
    def seeds(Bs, Hp, Wp, K, win):
        yi = rng.integers(0, Hp - win + 1, size=(Bs, K)).astype(np.int32)
        xi = rng.integers(0, Wp - win + 1, size=(Bs, K)).astype(np.int32)
        yi[:, :6] = [0, 0, Hp - win, Hp - win, -7, Hp]
        xi[:, :6] = [0, Wp - win, 0, Wp - win, Wp + 3, -1]
        return on_card(yi), on_card(xi)

    from caliscope_tpu_torch.kernel_times import host_ms

    padded = F.pad(imgs[:, None], (14, 14, 14, 14), mode="replicate")[:, 0].contiguous()  # the subpixel stage's frames
    atlas = on_card(rng.integers(0, 2**31 - 1, size=(B, H + H // 2 + H // 4 + 96, W)).astype(np.int32))  # the patch atlas's shape
    wide = on_card(rng.uniform(0, 255, size=(2, 768 + 28, 1366 + 28)).astype(np.float32))
    unaligned = torch.zeros(2 * 40 * 64 + 1, dtype=torch.float32, device=device)[1:].view(2, 40, 64)
    unaligned.copy_(on_card(rng.uniform(0, 255, size=(2, 40, 64)).astype(np.float32)))
    win_results = {}
    for what, src, K, win, path in (
        ("corner windows", padded, 256, 28, "tma"), ("atlas patches", atlas, 64, 96, "tma"),
        ("chessboard K=512", padded[:1].contiguous(), 512, 28, "tma"), ("odd K", padded[:3], 37, 28, "tma"),
        ("ragged", padded[:2, :97, :131].contiguous(), 8, 28, "rows"), ("win 17", padded[:2], 16, 17, "rows"),
        ("Wp % 4 != 0", wide, 64, 28, "rows"), ("unaligned base", unaligned, 8, 8, "rows"),
    ):
        yi, xi = seeds(src.shape[0], src.shape[1], src.shape[2], K, win)
        if CK.windows_path(src, win) != path:
            raise AssertionError(f"extract_windows {what}: the rule picks the {CK.windows_path(src, win)} path, not {path}")
        tma_before = CK.extract_windows.tma_launches
        got, want = CK.extract_windows(src, yi, xi, win), CK.extract_windows_plain(src, yi, xi, win)
        torch.cuda.synchronize()
        if CK.extract_windows.tma_launches - tma_before != (path == "tma"):
            raise AssertionError(f"extract_windows {what}: tma_launches grew by {CK.extract_windows.tma_launches - tma_before} "
                                 f"on the {path} path")
        if got.dtype != src.dtype or not torch.equal(got, want):
            raise AssertionError(f"extract_windows {what}: windows differ from the plain version's")
        log(f"kernel extract_windows {what} {tuple(src.shape)} {src.dtype} K={K} win={win}: {path} path, windows equal the "
            f"plain version's (torch.equal)")
        if what not in ("corner windows", "atlas patches", "chessboard K=512"):
            continue
        # the one-call yardstick: the advanced-indexing gather on prebuilt indices
        ar = torch.arange(win, device=device)
        bi = torch.arange(src.shape[0], device=device)[:, None, None, None]
        yy = yi.long().clamp(0, src.shape[1] - win)[:, :, None, None] + ar[:, None]
        xx = xi.long().clamp(0, src.shape[2] - win)[:, :, None, None] + ar[None, :]
        passes = device_ms_by_kernel(lambda: CK.extract_windows(src, yi, xi, win))
        log(f"kernel extract_windows {what}: device time by GPU kernel (torch.profiler, ms per launch, launches per call) {json.dumps(passes)}")
        win_results[what] = dict(
            device_ms=sum(rec["ms"] for rec in passes.values()),
            ms=time_ms(lambda: CK.extract_windows(src, yi, xi, win)),
            host_ms=host_ms(lambda: CK.extract_windows(src, yi, xi, win)),
            plain_ms=time_ms(lambda: CK.extract_windows_plain(src, yi, xi, win)),
            library_ms=time_ms(lambda: src[bi, yy, xx]),
            bytes=src.shape[0] * K * (2 * 4 * win * win + 8), shape=f"{tuple(src.shape)} {str(src.dtype).split('.')[-1]}, K={K}, win={win}",
        )
        log(f"kernel extract_windows {what}: {win_results[what]['host_ms'] * 1e3:.2f} us of host time a call (perf_counter over 50 "
            f"calls not waited for), {win_results[what]['ms'] * 1e3:.2f} us a call by CUDA events")
    caller_keys = ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    callers = {}
    for what, r in win_results.items():
        e = bound_entry("extract_windows", "caliscope_tpu_torch/csrc/extract_windows.cu", "caliscope_tpu/detect/pallas_kernels.py:203",
                        0.0, r["ms"], r["plain_ms"], r["library_ms"], r["bytes"], 0, peaks, r["shape"])
        callers[what] = {k: e.get(k, r.get(k)) for k in caller_keys} | {"path": "tma", "shape": r["shape"]}
    a = win_results["atlas patches"]
    win_entry = bound_entry(
        "extract_windows", "caliscope_tpu_torch/csrc/extract_windows.cu", "caliscope_tpu/detect/pallas_kernels.py:203", 0.0,
        a["ms"], a["plain_ms"], a["library_ms"], a["bytes"], 0, peaks, a["shape"],
    )
    win_entry["device_ms"], win_entry["host_ms"], win_entry["path"] = a["device_ms"], a["host_ms"], "tma"
    win_entry["corner_windows_caller"] = callers["corner windows"]
    win_entry["chessboard_k512_caller"] = callers["chessboard K=512"]

    # comparing and timing launches are not a path's
    (CCL.connected_components.launches, CCL.connected_components.resident_launches,
     CK.corner_response.launches, CK.extract_windows.launches, CK.extract_windows.tma_launches) = counts
    return [ccl_entry, resp_entry, win_entry]


def _same_packets(got, want, atol, what):
    import numpy as np

    for b, (g, w) in enumerate(zip(got, want)):
        if not (np.array_equal(g.keypoint_id, w.keypoint_id) and np.array_equal(g.object_id, w.object_id)):
            raise AssertionError(f"detection: frame {b}: {what}: different corner identities")
        if len(g) and not np.abs(g.img_loc - w.img_loc).max() <= atol:
            raise AssertionError(f"detection: frame {b}: {what}: img_loc differs by {np.abs(g.img_loc - w.img_loc).max():.3e} px")


def detect_slice_phase(device, ch, frames, truths, smi_line):
    """The 16-frame stack through CharucoTracker.get_points_batch on the
    card. Returns (launch counts of kernels 2-4, dispatches) of the warm call."""
    import numpy as np
    import torch

    from caliscope_tpu_torch.detect import ccl as CCL
    from caliscope_tpu_torch.detect import cuda_kernels as CK
    from caliscope_tpu_torch.trackers import CharucoTracker
    from caliscope_tpu_torch.trackers.charuco_tracker import _RUN_CHUNK

    tracker = CharucoTracker(ch)  # the default device: CUDA
    if tracker.device.type != "cuda":
        raise AssertionError(f"CharucoTracker resolved to {tracker.device}, not the card")
    t0 = time.perf_counter()
    first = tracker.get_points_batch(frames, 0)
    sync(device)
    first_s = time.perf_counter() - t0

    # the main path's run: counts from 0 just before, read just after
    CCL.connected_components.launches = CK.corner_response.launches = CK.extract_windows.launches = 0
    CCL.connected_components.resident_launches = CK.extract_windows.tma_launches = 0
    before = tracker.dispatches
    sync(device)
    t0 = time.perf_counter()
    packets = tracker.get_points_batch(frames, 0)
    sync(device)
    warm_s = time.perf_counter() - t0
    launches = (CCL.connected_components.launches, CK.corner_response.launches, CK.extract_windows.launches)
    resident = CCL.connected_components.resident_launches
    TMA_LAUNCHES_BY_RUN["detection slice"] = tma = CK.extract_windows.tma_launches
    dispatches = tracker.dispatches - before

    n_found = sum(len(p) for p in packets)
    if len(packets) != len(frames) or n_found < MIN_FOUND_FRACTION * len(frames) * ch.n_corners:
        raise AssertionError(f"detection: found {n_found} of {len(frames) * ch.n_corners} corners")
    errs = np.concatenate([np.linalg.norm(p.img_loc - gt[p.keypoint_id], axis=1) for p, gt in zip(packets, truths)])
    if not (np.isfinite(errs).all() and errs.max() < MAX_CORNER_ERROR_PX and errs.mean() < MAX_MEAN_CORNER_ERROR_PX):
        raise AssertionError(f"detection: corner error max {errs.max():.3f} px, mean {errs.mean():.3f} px")
    for p in packets:
        if not ((p.object_id == 0).all() and np.allclose(p.obj_loc, ch.object_corners(0)[p.keypoint_id])):
            raise AssertionError("detection: wrong object identity or obj_loc")
    _same_packets(packets, first, 0.0, "second call against the first")
    if launches != (dispatches, dispatches, 2 * dispatches) or dispatches < -(-len(frames) // _RUN_CHUNK):
        raise AssertionError(f"detection: launches (ccl, response, windows) {launches} for {dispatches} dispatches")
    if resident != dispatches:
        raise AssertionError(f"detection: {resident} of {dispatches} labelings of 720p frames went through the resident kernel")
    if tma != launches[2]:
        raise AssertionError(f"detection: {tma} of {launches[2]} window gathers took the TMA path (the atlas and corner windows "
                             "of 720p frames must)")
    cpu = CharucoTracker(ch, device="cpu").get_points_batch(frames[:2], 0)
    _same_packets(packets[:2], cpu, GPU_VS_CPU_ATOL_PX, "the card against the port on the CPU")
    gap = max(float(np.abs(g.img_loc - w.img_loc).max()) for g, w in zip(packets[:2], cpu))
    log(
        f"detection slice: {len(frames)} frames {frames.shape[2]}x{frames.shape[1]} on {device}: {n_found} of "
        f"{len(frames) * ch.n_corners} corners, error max {errs.max():.4f} px mean {errs.mean():.4f} px; first call "
        f"{first_s:.3f} s, warm call {warm_s:.4f} s = {len(frames) / warm_s:.1f} frames/s [{smi_line}]; {dispatches} "
        f"dispatches, launches ccl {launches[0]} (resident {resident}) response {launches[1]} windows {launches[2]} (TMA path "
        f"{tma}); the card's packets "
        f"within {gap:.2e} px of the port's CPU packets on 2 frames"
    )
    times = []
    for _ in range(5):
        sync(device)
        t0 = time.perf_counter()
        tracker.get_points_batch(frames, 0)
        sync(device)
        times.append(time.perf_counter() - t0)
    log(f"detection slice: 5 more warm calls: {' '.join(f'{t:.4f}' for t in times)} s (best {len(frames) / min(times):.1f} frames/s)")
    prof = profile_call(device, lambda: tracker.get_points_batch(frames, 0), top=12)
    log("detection profile (one warm call) " + (json.dumps(prof) if prof else "not measured (the profiler recorded no device time)"))
    CCL.connected_components.launches, CK.corner_response.launches, CK.extract_windows.launches = launches
    CCL.connected_components.resident_launches = resident
    return launches, dispatches


STAGES = (
    ("linear BA", lambda v: v.optimize()),
    (
        "robust BA",
        lambda v: v.optimize(
            loss="soft_l1", f_scale=v.pixel_f_scale(1.0), max_nfev=200, ftol=1e-4, strict=False,
            refine_intrinsics=True,
        ),
    ),
    ("percentile filter", lambda v: v.filter_by_percentile_error(2.5)),
    ("final BA", lambda v: v.optimize(refine_intrinsics=True)),
)


def slice_phase(device, n_points=N_POINTS, n_obs=N_OBS):
    """Returns (launches, schur_solves, stage records)."""
    import numpy as np
    import torch

    from caliscope_tpu_torch import convert
    from caliscope_tpu_torch.solvers import fused_schur as FS
    from caliscope_tpu_torch.volume import CaptureVolume

    truth, start, cam_idx, pt_idx, uv, _X = synth_rig(n_points=n_points, n_obs=n_obs)
    cameras = convert.camera_array(start)
    ip = convert.image_points(
        dict(sync_index=pt_idx, cam_id=cam_idx, object_id=np.zeros_like(pt_idx),
             keypoint_id=np.zeros_like(pt_idx), img_xy=uv)
    )
    t0 = time.perf_counter()
    wp = ip.triangulate(cameras, device=device)
    volume = CaptureVolume(cameras, ip, wp, device=device)
    rmse0 = volume.reprojection_report.overall_rmse
    log(
        f"slice: {len(cameras)} cameras, {len(wp)} points, {len(ip)} observations on {device}; "
        f"triangulated in {time.perf_counter() - t0:.3f} s, initial RMSE {rmse0:.3f} px"
    )
    errs, Pb = first_iteration_block_errors(device, volume)
    log(f"kernel schur_s_rhs on the first LM iteration's blocks (P = {Pb}): scaled max |kernel - plain| {errs} (rtol {BLOCK_RTOL})")
    if not all(e <= BLOCK_RTOL for e in errs.values()):
        raise AssertionError("schur_s_rhs disagrees with its plain version on the canonical problem's blocks")

    FS.schur_s_rhs.launches = 0  # counts from here on are the main path's
    records, volumes = [], [volume]
    for name, stage in STAGES:
        sync(device)
        t0 = time.perf_counter()
        volume = stage(volume)
        rmse = volume.reprojection_report.overall_rmse
        seconds = time.perf_counter() - t0
        st = volume.optimization_status
        rec = dict(stage=name, seconds=seconds, rmse_px=rmse, n_obs=len(volume.image_points))
        if st is not None:
            rec.update(iterations=st.iterations, cost=st.final_cost, converged=st.converged,
                       ms_per_iteration=1e3 * seconds / max(st.iterations, 1))
        records.append(rec)
        volumes.append(volume)
        log("stage " + json.dumps(rec))
    launches = FS.schur_s_rhs.launches
    schur_solves = sum(r.get("iterations", 0) for r in records)

    # checks: cost and RMSE fall, final RMSE at the noise level, the rig is
    # the true one up to the free gauge
    if not all(np.isfinite(r["rmse_px"]) for r in records):
        raise AssertionError("slice: non-finite reprojection error")
    if not records[0]["rmse_px"] < rmse0:
        raise AssertionError(f"slice: linear BA did not lower the RMSE ({rmse0} -> {records[0]['rmse_px']})")
    if not records[1]["cost"] <= records[0]["cost"] * (1 + 1e-6) or not records[3]["cost"] < records[1]["cost"]:
        raise AssertionError("slice: the cost did not fall through the stages")
    if not records[-1]["rmse_px"] < MAX_FINAL_RMSE_PX:
        raise AssertionError(f"slice: final RMSE {records[-1]['rmse_px']:.3f} px is not below {MAX_FINAL_RMSE_PX}")
    final = volume.camera_array
    centers = lambda cams: np.stack([-c.rotation.T @ c.translation for _, c in sorted(cams.cameras.items())])  # noqa: E731
    center_err = umeyama_center_error(centers(convert.camera_array(truth)), centers(final))
    log(f"slice: camera centers within {center_err * 1e3:.3f} mm of the truth after similarity alignment")
    if not center_err < MAX_CENTER_ERROR_M:
        raise AssertionError(f"slice: camera centers {center_err * 1e3:.2f} mm off (limit {MAX_CENTER_ERROR_M * 1e3} mm)")

    # the final stage again without the kernel: same optimum
    rerun = volumes[3].optimize(refine_intrinsics=True, fused_schur=False)
    c_kernel, c_plain = records[3]["cost"], rerun.optimization_status.final_cost
    log(
        f"slice: final BA without the kernel: cost {c_plain:.9e} in {rerun.optimization_status.iterations} "
        f"iterations vs {c_kernel:.9e} with it (rtol {SOLVE_COST_RTOL})"
    )
    if not abs(c_kernel - c_plain) <= SOLVE_COST_RTOL * abs(c_plain):
        raise AssertionError("slice: kernel and kernel-less Schur paths reached different costs")
    return launches, schur_solves, records, volumes[3]


def scaled_errors(got, want, bp_t):
    """Max |got - want| of (S, rhs, Hpp_inv), each entry divided by its
    Cauchy-Schwarz bound from the positive semi-definite `want`:
    |S_ij| <= sqrt(S_ii S_jj), |rhs_i| <= sqrt(S_ii) sqrt(sum_p bp_p^T
    Hpp_inv_p bp_p), |Hpp_inv_jk| <= sqrt(Hpp_inv_jj Hpp_inv_kk). Entries
    whose bound is 0 (frozen parameters) must be exactly equal."""
    import torch

    S_g, rhs_g, H_g = got
    S_w, rhs_w, H_w = want
    tiny = torch.finfo(S_w.dtype).tiny
    ds = S_w.diagonal().clamp(min=0).sqrt()
    beta = torch.einsum("jp,jkp,kp->", bp_t, H_w, bp_t).clamp(min=0).sqrt()
    dh = torch.stack([H_w[0, 0], H_w[1, 1], H_w[2, 2]]).clamp(min=0).sqrt()  # (3,P)
    out = {}
    for name, diff, scale in (
        ("S", S_g - S_w, ds[:, None] * ds[None, :]),
        ("rhs", rhs_g - rhs_w, ds * beta),
        ("Hpp_inv", H_g - H_w, dh[:, None] * dh[None, :]),
    ):
        out[name] = float((diff.abs() / scale.clamp(min=tiny)).max())
    return out


def first_iteration_block_errors(device, volume):
    """schur_s_rhs against schur_s_rhs_plain on the blocks the first LM
    iteration of linear BA on `volume` hands it (start cameras, triangulated
    points, the start damping): (scaled errors as `scaled_errors` gives
    them, bucketed point count). Its launch is not the main path's."""
    import torch

    from caliscope_tpu_torch.solvers import bundle
    from caliscope_tpu_torch.solvers import fused_schur as FS

    problem, cam9, X0 = volume.ba_problem()  # the dense problem optimize builds
    on_dev = dict(dtype=problem.uv.dtype, device=device)
    r, w, Jc, Jp, _ = bundle._masked_blocks_dense(
        problem, torch.as_tensor(cam9, **on_dev), torch.as_tensor(X0, **on_dev), "linear", 1.0
    )
    _g_c, g_p, _d_c = bundle._gradient_and_diag_dense(w, r, Jc, Jp)
    bp_t = (-g_p).T.contiguous()
    lam = torch.tensor(bundle.BAConfig().init_lambda, **on_dev)
    got = FS.schur_s_rhs(Jc, Jp, w, bp_t, lam)
    want = FS.schur_s_rhs_plain(Jc, Jp, w, bp_t, lam)
    for name, t in zip(("S", "rhs", "Hpp_inv"), got):
        if not torch.isfinite(t).all():
            raise AssertionError(f"schur_s_rhs: non-finite {name} on the first LM iteration's blocks")
    return scaled_errors(got, want, bp_t), problem.n_points


def lm_iteration_times(device, volume, iters=10):
    """Best ms per LM iteration of the filtered canonical problem at a fixed
    iteration count, with and without the kernel, run in turns (plain,
    kernel, kernel, plain)."""
    from caliscope_tpu_torch.solvers import bundle

    problem, cam9, X0 = volume.ba_problem()  # the dense problem optimize builds
    config = bundle.BAConfig(max_iter=iters, ftol=0.0, xtol=0.0, gtol=0.0, solver="schur")
    times = {True: [], False: []}
    for fused in (False, True, True, False):
        sync(device)
        t0 = time.perf_counter()
        res = bundle.lm_solve(problem, cam9, X0, config, fused_schur=fused)
        sync(device)
        times[fused].append(1e3 * (time.perf_counter() - t0) / res.n_iterations)
        if res.n_iterations != iters:
            raise AssertionError(f"fixed-iteration solve stopped after {res.n_iterations} iterations")
    return min(times[True]), min(times[False]), problem.n_points


def profile_call(device, fn, units=1, top=6):
    """torch.profiler over one call of `fn` (after a warm one): wall ms (with
    the profiler's own overhead), device-busy share (sum of GPU kernel times
    over wall time; one stream, so kernels do not overlap), GPU kernels
    launched, and the top kernels and the top operators (with their input
    shapes) by device time, each divided by `units`. Returns None when the
    profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    ops = sorted(
        (e for e in prof.key_averages(group_by_input_shape=True) if e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )[:top]
    return {
        "wall_ms": wall_us / 1e3 / units,
        "device_busy_share": busy_us / wall_us,
        "device_ms": busy_us / 1e3 / units,
        "gpu_kernels": len(kernels) / units,
        "top_kernels_device_ms": {name[:90]: us / 1e3 / units for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]},
        "top_ops_device_ms": {f"{e.key} {e.input_shapes}"[:100]: e.self_device_time_total / 1e3 / units for e in ops},
    }


def profile_lm_iterations(device, volume, iters=3):
    """`profile_call` over a fixed-iteration kernel-path solve of the
    filtered canonical problem, per LM iteration."""
    from caliscope_tpu_torch.solvers import bundle

    problem, cam9, X0 = volume.ba_problem()  # the dense problem optimize builds
    config = bundle.BAConfig(max_iter=iters, ftol=0.0, xtol=0.0, gtol=0.0, solver="schur")
    return profile_call(device, lambda: bundle.lm_solve(problem, cam9, X0, config), units=iters)


# ---------------------------------------------------------------------------
# Pipeline: calibrate_extrinsics from unposed cameras
# ---------------------------------------------------------------------------


def align_to_truth(volume, truth):
    """`volume` moved onto the truth's camera centers by Umeyama (with
    scale), and per posed camera (rotation error deg, center error m)."""
    import numpy as np

    from caliscope_tpu_torch.ops.lie import rotation_geodesic_angle_host
    from caliscope_tpu_torch.ops.similarity import SimilarityParams, umeyama

    posed = sorted(volume.camera_array.posed_cameras)
    center = lambda c: -c.rotation.T @ c.translation  # noqa: E731
    src = np.array([center(volume.camera_array.cameras[c]) for c in posed])
    dst = np.array([center(truth.cameras[c]) for c in posed])
    s, R, t = umeyama(src, dst)
    aligned = volume._apply_similarity(SimilarityParams(float(s), R.numpy(), t.numpy()))
    errors = {}
    for c in posed:
        a, g = aligned.camera_array.cameras[c], truth.cameras[c]
        errors[c] = (
            float(np.degrees(rotation_geodesic_angle_host(a.rotation, g.rotation))),
            float(np.linalg.norm(center(a) - center(g))),
        )
    return aligned, errors


class PipelineRecorder:
    """Instrumentation of calibrate_extrinsics runs: wall time between the
    pipeline's progress calls, the bootstrap's volume, and per BA solve its
    wall seconds, LM iterations and Schur kernel launches, with its input
    volume, arguments and result in `calls`."""

    def __init__(self):
        self.marks, self.solves, self.calls, self.results, self.boot = [], [], [], [], None

    def progress(self, pct, label):
        self.marks.append((time.perf_counter(), label))

    def stage_seconds(self):
        return {a[1]: b[0] - a[0] for a, b in zip(self.marks, self.marks[1:])}

    @contextmanager
    def patched(self):
        from caliscope_tpu_torch.solvers import bundle
        from caliscope_tpu_torch.solvers import fused_schur as FS
        from caliscope_tpu_torch.volume import CaptureVolume

        optimize, bootstrap, lm_solve = CaptureVolume.optimize, CaptureVolume.bootstrap.__func__, bundle.lm_solve

        def recorded_lm_solve(problem, *args, **kwargs):
            res = lm_solve(problem, *args, **kwargs)
            self.results.append(dict(
                layout="sparse" if isinstance(problem, bundle.BAProblem) else "dense", obs_minor=res.obs_minor,
                solver=res.solver, n_constraints=problem.n_constraints, n_points=int(res.X.shape[0]),
                cg_iterations=list(res.cg_iterations),
            ))
            return res

        def recorded_optimize(volume, *args, **kwargs):
            n0, t0 = FS.schur_s_rhs.launches, time.perf_counter()
            out = optimize(volume, *args, **kwargs)
            st = out.optimization_status
            self.solves.append(dict(
                seconds=time.perf_counter() - t0, iterations=st.iterations, converged=st.converged,
                launches=FS.schur_s_rhs.launches - n0, loss=kwargs.get("loss", "linear"),
                refine_intrinsics=kwargs.get("refine_intrinsics", False), n_obs=len(volume.image_points),
            ))
            self.calls.append((volume, args, kwargs, out))
            return out

        def recorded_bootstrap(cls, *args, **kwargs):
            self.boot = bootstrap(cls, *args, **kwargs)
            return self.boot

        CaptureVolume.optimize, CaptureVolume.bootstrap = recorded_optimize, classmethod(recorded_bootstrap)
        bundle.lm_solve = recorded_lm_solve
        try:
            yield self
        finally:
            CaptureVolume.optimize, CaptureVolume.bootstrap = optimize, classmethod(bootstrap)
            bundle.lm_solve = lm_solve


def run_pipeline(device, scene_size, what):
    """The port's default_ring_scene through calibrate_extrinsics on
    `device`, from the truth's intrinsics without extrinsics. Returns
    (recorder, run, scene, seconds)."""
    from caliscope_tpu_torch.pipelines import calibrate_extrinsics
    from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics
    from caliscope_tpu_torch.synthetic.factories import default_ring_scene

    t0 = time.perf_counter()
    scene = default_ring_scene(*scene_size)
    ip = scene.image_points_noisy()
    log(f"pipeline {what}: default_ring_scene{scene_size}: {len(ip)} observations, "
        f"{len(scene.world_points())} points, built on the host in {time.perf_counter() - t0:.2f} s")
    rec = PipelineRecorder()
    with rec.patched():
        sync(device)
        t0 = time.perf_counter()
        run = calibrate_extrinsics(ip, strip_extrinsics(scene.cameras), None, device=device, progress=rec.progress)
        sync(device)
        seconds = time.perf_counter() - t0
    return rec, run, scene, ip, seconds


BOOTSTRAP_PARTS = (
    "estimate_camera_object_poses", "relative_pose_samples", "reject_outliers", "aggregate_pairs", "stereo_rmse_batch",
    "from_raw_estimates", "triangulate", "reprojection_report", "_repair_bootstrap_outlier_cameras",
)


def bootstrap_costs(device, ip, cameras):
    """One more bootstrap of the same data on the card, under torch.profiler
    (device time: the sum of its GPU kernels' durations), with CUDA's sync
    debug mode on (one warning per synchronising operation it detects) and
    under cProfile (cumulative host seconds of the bootstrap's parts, with
    cProfile's own overhead). Returns (device s, GPU kernels, syncs, parts)."""
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import torch

    from caliscope_tpu_torch.volume import CaptureVolume

    host = cProfile.Profile()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warnings.simplefilter("always")
            host.enable()
            CaptureVolume.bootstrap(ip, cameras, device=device)
            sync(device)
            host.disable()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    parts = {}
    for (path, _line, name), (_cc, _nc, _tt, cum, _callers) in pstats.Stats(host).stats.items():
        if name in BOOTSTRAP_PARTS and "caliscope_tpu_torch" in path:
            parts[name] = round(parts.get(name, 0.0) + cum, 4)
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e6, len(kernels), syncs, parts


def pnp_float64_check(device, ip, cameras):
    """The bootstrap's PnP batch as the port runs it on the card (float32)
    beside a float64 run: the same groups kept, and how far apart the two
    resections are. A flat board's smallest scatter eigenvalue in float32 is
    roundoff within a decade of the planarity limit, so this runs every
    time and fails past PNP_F32_MAX_GAP_DEG."""
    import numpy as np
    import torch

    from caliscope_tpu_torch.ops.lie import rotation_geodesic_angle_host, so3_exp_host
    from caliscope_tpu_torch.solvers.pose_network import estimate_camera_object_poses

    out = {}
    for name, dt in (("float32", None), ("float64", torch.float64)):
        sync(device)
        t0 = time.perf_counter()
        out[name] = estimate_camera_object_poses(ip, cameras, device=device, dtype=dt)
        sync(device)
        out[name + "_s"] = time.perf_counter() - t0
    a, b = out["float32"], out["float64"]
    same_groups = len(a.cam_id) == len(b.cam_id) and all(
        np.array_equal(getattr(a, k), getattr(b, k)) for k in ("sync_index", "cam_id", "object_id")
    )
    if not same_groups:
        raise AssertionError(f"pipeline: the PnP batch keeps {len(a.cam_id)} groups in float32, {len(b.cam_id)} in float64")
    ang = np.degrees(rotation_geodesic_angle_host(so3_exp_host(a.rvec), so3_exp_host(b.rvec)))
    log(f"pipeline: PnP batch of the bootstrap, {len(a.cam_id)} groups kept in float32 ({out['float32_s']:.3f} s) and "
        f"float64 ({out['float64_s']:.3f} s): rotation gap max {ang.max():.3e} deg (median {np.median(ang):.3e}), "
        f"translation gap max {np.linalg.norm(a.tvec - b.tvec, axis=1).max():.3e} m")
    if not ang.max() <= PNP_F32_MAX_GAP_DEG:
        raise AssertionError(f"pipeline: float32 PnP {ang.max():.3e} deg from float64 (limit {PNP_F32_MAX_GAP_DEG})")


def pipeline_phase(device, smi_line):
    """Returns (the Schur kernel's launches on the pipeline path, the run's
    stage wall seconds, its scene and image points)."""
    import numpy as np
    import torch

    from caliscope_tpu_torch.solvers import fused_schur as FS
    from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics

    FS.schur_s_rhs.launches = 0  # counts from here on are the pipeline's
    rec, run, scene, ip, seconds = run_pipeline(device, PIPE_SCENE, "on the card")
    launches = FS.schur_s_rhs.launches
    volume = run.capture_volume
    n_cams = len(scene.cameras.cameras)
    stages = {k: round(v, 4) for k, v in rec.stage_seconds().items()}
    log(f"pipeline on the card: {seconds:.2f} s in all [{smi_line}]; stage wall seconds {json.dumps(stages)}")
    for solve, name in zip(rec.solves, ("linear BA", "robust BA", "final BA")):
        log(f"pipeline {name}: " + json.dumps(solve))
    log(f"pipeline: depth-ratio gate {'held the intrinsics fixed' if run.intrinsic_refinement_gated else 'let the intrinsics be refined'}; "
        f"{len(volume.image_points)} of {len(ip)} observations kept; final RMSE {volume.reprojection_report.overall_rmse:.4f} px")
    schur_solves = sum(s["iterations"] for s in rec.solves)
    posed_by_boot = len(rec.boot.camera_array.posed_cameras) if rec.boot is not None else 0
    if posed_by_boot != n_cams:
        raise AssertionError(f"pipeline: the bootstrap posed {posed_by_boot} of {n_cams} cameras")
    if not volume.reprojection_report.overall_rmse < MAX_FINAL_RMSE_PX:
        raise AssertionError(f"pipeline: final RMSE {volume.reprojection_report.overall_rmse:.3f} px")
    _aligned, errors = align_to_truth(volume, scene.cameras)
    max_rot = max(e[0] for e in errors.values())
    max_center = max(e[1] for e in errors.values())
    log(f"pipeline: against the truth after Umeyama on the camera centers, rotation error max {max_rot:.5f} deg, "
        f"center error max {max_center * 1e3:.4f} mm")
    if len(errors) != n_cams or not (max_rot <= MAX_PIPE_ROTATION_DEG and max_center <= MAX_PIPE_CENTER_M):
        raise AssertionError(f"pipeline: rig off the truth: {errors}")
    if len(rec.solves) != 3 or launches < 1 or launches != schur_solves or sum(s["launches"] for s in rec.solves) != launches:
        raise AssertionError(f"pipeline: schur_s_rhs launched {launches} times for {schur_solves} Schur solves ({rec.solves})")
    log(f"pipeline: schur_s_rhs launches {launches} = Schur solves {schur_solves} over the three BA stages")

    # the kernel on this path's own blocks: the first LM iteration of linear
    # BA on the bootstrap's volume, against the plain version
    errs, Pb = first_iteration_block_errors(device, rec.boot)
    log(f"pipeline: kernel schur_s_rhs on linear BA's first LM iteration (C = {n_cams}, P = {Pb}): "
        f"scaled max |kernel - plain| {errs} (rtol {BLOCK_RTOL})")
    if Pb != PIPE_BUCKET or not all(e <= BLOCK_RTOL for e in errs.values()):
        raise AssertionError(f"pipeline: schur_s_rhs disagrees with its plain version at P = {Pb}: {errs}")
    # the final BA again from its own input without the kernel: same optimum
    final_in, args, kwargs, final_out = rec.calls[2]
    rerun = final_in.optimize(*args, **{**kwargs, "fused_schur": False})
    c_kernel, c_plain = final_out.optimization_status.final_cost, rerun.optimization_status.final_cost
    log(f"pipeline: final BA without the kernel: cost {c_plain:.9e} in {rerun.optimization_status.iterations} "
        f"iterations vs {c_kernel:.9e} with it (rtol {SOLVE_COST_RTOL})")
    if not abs(c_kernel - c_plain) <= SOLVE_COST_RTOL * abs(c_plain):
        raise AssertionError("pipeline: kernel and kernel-less Schur paths reached different final costs")

    cameras = strip_extrinsics(scene.cameras)
    wall = stages["Bootstrapping poses"]
    device_s, n_kernels, syncs, parts = bootstrap_costs(device, ip, cameras)
    log(f"pipeline bootstrap: wall {wall:.3f} s (the pipeline's stage), of it {device_s:.4f} s of device time in "
        f"{n_kernels} GPU kernels (torch.profiler, a second bootstrap) and {wall - device_s:.3f} s on the host; "
        f"{syncs} device->host synchronisations (CUDA sync debug mode, the second bootstrap; a prototype that "
        f"does not detect every synchronising operation, so a lower bound); cumulative seconds of its parts under "
        f"cProfile (the second bootstrap, with cProfile's overhead) {json.dumps(parts)}")
    pnp_float64_check(device, ip, cameras)

    # the card against the port's own CPU run, 4 cameras x 20 frames
    aligned = {}
    for dev in (device, torch.device("cpu")):
        _r, small, small_scene, _ip, small_s = run_pipeline(dev, PIPE_SMALL, f"on {dev.type}")
        aligned[dev.type], errs = align_to_truth(small.capture_volume, small_scene.cameras)
        log(f"pipeline {PIPE_SMALL} on {dev.type}: {small_s:.2f} s, rotation error max "
            f"{max(e[0] for e in errs.values()):.5f} deg, center error max {max(e[1] for e in errs.values()) * 1e3:.4f} mm")
    from caliscope_tpu_torch.ops.lie import rotation_geodesic_angle_host

    gaps = []
    for cid, g in aligned["cuda"].camera_array.posed_cameras.items():
        c = aligned["cpu"].camera_array.cameras[cid]
        gaps.append((float(np.degrees(rotation_geodesic_angle_host(g.rotation, c.rotation))),
                     float(np.linalg.norm(g.rotation.T @ g.translation - c.rotation.T @ c.translation))))
    gap_rot, gap_center = max(g[0] for g in gaps), max(g[1] for g in gaps)
    log(f"pipeline {PIPE_SMALL}: the card within {gap_rot:.3e} deg and {gap_center * 1e3:.4f} mm of the CPU run")
    if len(gaps) != PIPE_SMALL[0] or not (gap_rot <= CARD_VS_CPU_ROTATION_DEG and gap_center <= CARD_VS_CPU_CENTER_M):
        raise AssertionError(f"pipeline: the card's 4 x 20 rig differs from the CPU's: {gaps}")
    return launches, stages, scene, ip


# ---------------------------------------------------------------------------
# Constrained and sparse pipelines: the production ChArUco flow
# ---------------------------------------------------------------------------


def truss_set(scene, extra_static=()):
    """The board truss of `scene`'s board (spacing 0.054 m, sigma 2 mm), as
    the JAX package's board_constraints builds it, plus each static marker
    of `extra_static` as its six corner distances, declared static."""
    import numpy as np

    from caliscope_tpu_torch.constraints import ConstraintSet, DistanceConstraint

    cons = list(ConstraintSet._truss_constraints(scene.objects[0].points_local, 0.054, 0.002))
    for obj in extra_static:
        pts = obj.points_local
        cons += [
            DistanceConstraint(obj.object_id, i, obj.object_id, j, float(np.linalg.norm(pts[i] - pts[j])), 0.002)
            for i in range(len(pts)) for j in range(i + 1, len(pts))
        ]
    return ConstraintSet(tuple(cons), frozenset(o.object_id for o in extra_static))


def constrained_scenes(size, ring, ring_ip):
    """{run: (scene, image points, constraint set)} for the three runs; (a)
    reuses the unconstrained pipeline's default_ring_scene and its points."""
    from caliscope_tpu_torch.constraints import ConstraintSet
    from caliscope_tpu_torch.synthetic.factories import ring_with_static_markers, two_sided_ring_scene

    two, ch = two_sided_ring_scene(*size)
    static = ring_with_static_markers(*size, N_STATIC_MARKERS)
    return {
        "a_board_truss": (ring, ring_ip, truss_set(ring)),
        "b_two_sided": (two, two.image_points_noisy(), ConstraintSet.from_charuco(ch)),
        "c_static_markers": (static, static.image_points_noisy(), truss_set(static, static.objects[1:])),
    }


def ba_stage_costs(device, volume, args, kwargs):
    """One BA stage (optimize(*args, **kwargs) on `volume`) repeated on the
    card under torch.profiler and CUDA's sync debug mode: (device seconds,
    GPU kernels, device->host synchronisations (a lower bound: the debug
    mode does not see every synchronising operation), wall seconds with
    the tools' overhead)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            volume.optimize(*args, **kwargs)
            sync(device)
            wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e6, len(kernels), syncs, wall


def run_constrained(device, name, scene, ip, cs):
    """One constrained pipeline run on the card with its gates. Returns
    (recorder, run, record)."""
    from caliscope_tpu_torch.pipelines import calibrate_extrinsics
    from caliscope_tpu_torch.pipelines.calibrate_extrinsics import _count_active_cross_face_ties
    from caliscope_tpu_torch.solvers import fused_schur as FS
    from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics

    rec = PipelineRecorder()
    n0 = FS.schur_s_rhs.launches
    with rec.patched():
        sync(device)
        t0 = time.perf_counter()
        run = calibrate_extrinsics(ip, strip_extrinsics(scene.cameras), cs, device=device, progress=rec.progress)
        sync(device)
        seconds = time.perf_counter() - t0
    launches = FS.schur_s_rhs.launches - n0
    volume = run.capture_volume
    n_cams = len(scene.cameras.cameras)
    _aligned, errors = align_to_truth(volume, scene.cameras)
    rigidity = volume.rigidity_report()
    record = dict(
        observations=len(ip), points=len(rec.boot.world_points), constraint_rows=rec.results[0]["n_constraints"],
        seconds=round(seconds, 3), stage_seconds={k: round(v, 4) for k, v in rec.stage_seconds().items()},
        final_rmse_px=volume.reprojection_report.overall_rmse,
        max_rotation_deg=max(e[0] for e in errors.values()), max_center_mm=1e3 * max(e[1] for e in errors.values()),
        rigidity_rmse_mm=rigidity.rmse_mm, rigidity_rows=rigidity.n_violations,
        dropped_static_markers=list(run.dropped_static_markers), schur_kernel_launches=launches,
    )
    if name == "b_two_sided":
        record["cross_face_ties_active"] = _count_active_cross_face_ties(rec.boot, cs)
    log(f"constrained {name}: " + json.dumps(record))
    for solve, res, stage in zip(rec.solves, rec.results, ("linear BA", "robust BA", "final BA")):
        cg = res["cg_iterations"]
        log(f"constrained {name} {stage}: {solve['seconds']:.3f} s, {solve['iterations']} LM iterations, "
            f"layout {res['layout']}{' obs-minor' if res['obs_minor'] else ''}, solver {res['solver']}, "
            f"{res['n_constraints']} constraint rows, P = {res['n_points']}, CG iterations per LM iteration {cg} "
            f"(mean {sum(cg) / max(len(cg), 1):.1f}, max {max(cg, default=0)})")

    posed_by_boot = len(rec.boot.camera_array.posed_cameras)
    if posed_by_boot != n_cams or len(errors) != n_cams:
        raise AssertionError(f"constrained {name}: {posed_by_boot} cameras posed by the bootstrap, {len(errors)} at the end, of {n_cams}")
    if not record["final_rmse_px"] < MAX_FINAL_RMSE_PX:
        raise AssertionError(f"constrained {name}: final RMSE {record['final_rmse_px']:.3f} px")
    if not (record["max_rotation_deg"] <= MAX_PIPE_ROTATION_DEG and record["max_center_mm"] <= 1e3 * MAX_PIPE_CENTER_M):
        raise AssertionError(f"constrained {name}: rig off the truth: {errors}")
    if name == "c_static_markers":
        if run.dropped_static_markers != ():
            raise AssertionError(f"constrained {name}: static markers dropped: {run.dropped_static_markers}")
        if not all(r["layout"] == "sparse" for r in rec.results):
            raise AssertionError(f"constrained {name}: a BA stage did not take the sparse row layout: {rec.results}")
    elif not (rigidity.n_violations > 0 and rigidity.rmse_mm < MAX_RIGIDITY_MM):
        raise AssertionError(f"constrained {name}: rigidity {rigidity.rmse_mm:.3f} mm over {rigidity.n_violations} rows")
    if name == "b_two_sided" and not record["cross_face_ties_active"] > 0:
        raise AssertionError(f"constrained {name}: no cross-face tie active")
    if launches != 0 or any(s["launches"] for s in rec.solves):
        raise AssertionError(f"constrained {name}: the Schur kernel launched {launches} times; its gate is closed here")
    if not all(r["n_constraints"] > 0 for r in rec.results):
        raise AssertionError(f"constrained {name}: a BA stage ran without constraint rows: {rec.results}")
    return rec, run, record


def layout_times(device, volume):
    """ms per LM iteration of `volume`'s final-BA problem (the sparse row
    layout) in the row-major and obs-minor layouts at a fixed iteration
    count, in turns (row-major, obs-minor, obs-minor, row-major, row-major,
    obs-minor), with the CG iterations each ran. Returns ({layout: (best ms, CG iterations)},
    whether 'auto' takes obs-minor)."""
    from caliscope_tpu_torch.solvers import bundle

    problem, cam9, X0 = volume.ba_problem()
    if not isinstance(problem, bundle.BAProblem):
        raise AssertionError("layout timing: the static-marker problem is not on the sparse row layout")
    out = {}
    for policy in ("never", "always", "always", "never", "never", "always"):
        config = bundle.BAConfig(max_iter=LAYOUT_TIMING_ITERS, ftol=0.0, xtol=0.0, gtol=0.0, solver="schur", obs_minor=policy)
        sync(device)
        t0 = time.perf_counter()
        res = bundle.lm_solve(problem, cam9, X0, config)
        sync(device)
        ms = 1e3 * (time.perf_counter() - t0) / res.n_iterations
        key = "obs_minor" if policy == "always" else "row_major"
        best = out.get(key)
        if best is None or ms < best[0]:
            out[key] = (ms, list(res.cg_iterations))
    return out, bundle._use_obs_minor(problem, "auto")


def solver_checks(device, volume):
    """'cg' and 'schur_cg' on the canonical BA problem (the filtered
    eight-camera volume of the BA slice) against the 'schur' optimum."""
    from caliscope_tpu_torch.solvers import bundle

    problem, cam9, X0 = volume.ba_problem()
    out = {}
    for solver in ("schur", "cg", "schur_cg"):
        sync(device)
        t0 = time.perf_counter()
        res = bundle.lm_solve(problem, cam9, X0, bundle.BAConfig(solver=solver))
        sync(device)
        cg = res.cg_iterations
        out[solver] = res.cost_final
        log(f"canonical problem, solver {solver}: cost {res.cost_final:.9e} in {res.n_iterations} LM iterations, "
            f"{time.perf_counter() - t0:.3f} s, CG iterations per LM iteration mean {sum(cg) / max(len(cg), 1):.1f} "
            f"max {max(cg, default=0)}, fused kernel {res.fused_schur}")
    for solver in ("cg", "schur_cg"):
        gap = abs(out[solver] - out["schur"]) / abs(out["schur"])
        if not gap <= SOLVER_COST_RTOL:
            raise AssertionError(f"solver {solver}: final cost {gap:.2e} relative from the 'schur' optimum (limit {SOLVER_COST_RTOL})")
    return out


def repeat_bits(device, rec):
    """The final BA stage of a constrained run again from its own input,
    twice: do the two solves give the same bits?"""
    import numpy as np

    volume, args, kwargs, _out = rec.calls[-1]
    a = volume.optimize(*args, **kwargs)
    b = volume.optimize(*args, **kwargs)
    same_points = np.array_equal(a.world_points.xyz, b.world_points.xyz)
    cams = sorted(a.camera_array.posed_cameras)
    gaps = [np.abs(a.camera_array.cameras[c].translation - b.camera_array.cameras[c].translation).max() for c in cams]
    same_cams = all(
        np.array_equal(a.camera_array.cameras[c].rotation, b.camera_array.cameras[c].rotation)
        and np.array_equal(a.camera_array.cameras[c].translation, b.camera_array.cameras[c].translation)
        for c in cams
    )
    return dict(
        bit_identical=bool(same_points and same_cams),
        max_point_gap_m=float(np.abs(a.world_points.xyz - b.world_points.xyz).max()),
        max_translation_gap_m=float(max(gaps)),
        costs=[a.optimization_status.final_cost, b.optimization_status.final_cost],
    )


def small_two_sided_card_vs_cpu(device):
    """two_sided_ring_scene() (6 x 24) through the constrained pipeline on
    the card and on the CPU: (max rotation gap deg, max center gap m)."""
    import numpy as np
    import torch

    from caliscope_tpu_torch.constraints import ConstraintSet
    from caliscope_tpu_torch.ops.lie import rotation_geodesic_angle_host
    from caliscope_tpu_torch.pipelines import calibrate_extrinsics
    from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics
    from caliscope_tpu_torch.synthetic.factories import two_sided_ring_scene

    scene, ch = two_sided_ring_scene()
    ip, cs = scene.image_points_noisy(), ConstraintSet.from_charuco(ch)
    aligned = {}
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        run = calibrate_extrinsics(ip, strip_extrinsics(scene.cameras), cs, device=dev)
        aligned[dev.type], errs = align_to_truth(run.capture_volume, scene.cameras)
        log(f"constrained two_sided_ring_scene() on {dev.type}: {time.perf_counter() - t0:.2f} s, rotation error max "
            f"{max(e[0] for e in errs.values()):.5f} deg, center error max {max(e[1] for e in errs.values()) * 1e3:.4f} mm, "
            f"rigidity {run.capture_volume.rigidity_report().rmse_mm:.4f} mm")
    gaps = []
    for cid, g in aligned["cuda"].camera_array.posed_cameras.items():
        c = aligned["cpu"].camera_array.cameras[cid]
        gaps.append((float(np.degrees(rotation_geodesic_angle_host(g.rotation, c.rotation))),
                     float(np.linalg.norm(g.rotation.T @ g.translation - c.rotation.T @ c.translation))))
    if len(gaps) != len(scene.cameras.cameras):
        raise AssertionError(f"constrained two-sided 6 x 24: {len(gaps)} cameras posed on the card")
    return max(g[0] for g in gaps), max(g[1] for g in gaps)


def constrained_phase(device, smi_line, unconstrained_stages, ring, ring_ip, canonical_volume):
    """Returns the Schur kernel's launches over the three constrained runs
    (0: its gate is closed for constrained and sparse problems) and run
    (c)'s capture volume (the static-marker problem, sparse rows)."""
    from caliscope_tpu_torch.solvers import fused_schur as FS

    t0 = time.perf_counter()
    scenes = constrained_scenes(CONSTRAINED_SCENE, ring, ring_ip)
    log(f"constrained: built the two-sided and static-marker {CONSTRAINED_SCENE} scenes on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    FS.schur_s_rhs.launches = 0  # counts from here on are the constrained runs'
    runs = {}
    for name, (scene, ip, cs) in scenes.items():
        runs[name] = run_constrained(device, name, scene, ip, cs)
    launches = FS.schur_s_rhs.launches
    log(f"constrained: schur_s_rhs launches {launches} over the three runs [{smi_line}]")

    stages_a = runs["a_board_truss"][2]["stage_seconds"]
    log("constrained (a) board truss beside the unconstrained pipeline, stage wall seconds: " + json.dumps(
        {k: {"constrained": stages_a.get(k), "unconstrained": round(unconstrained_stages.get(k, float("nan")), 4)} for k in stages_a}
    ))
    for name, (rec, _run, _record) in runs.items():
        volume, args, kwargs, _out = rec.calls[-1]
        device_s, n_kernels, syncs, wall = ba_stage_costs(device, volume, args, kwargs)
        log(f"constrained {name} final BA repeated under torch.profiler and sync debug mode: wall {wall:.3f} s, "
            f"device time {device_s:.4f} s in {n_kernels} GPU kernels, {syncs} device->host synchronisations [{smi_line}]")

    times, auto_minor = layout_times(device, runs["c_static_markers"][1].capture_volume)
    for layout, (ms, cg) in times.items():
        log(f"constrained (c) static-marker problem, {layout}: {ms:.3f} ms per LM iteration (best of 3 runs of "
            f"{LAYOUT_TIMING_ITERS} each, the layouts in turns), CG iterations {cg} [{smi_line}]")
    faster = min(times, key=lambda k: times[k][0])
    log(f"constrained (c): the faster layout is {faster}; 'auto' takes {'obs_minor' if auto_minor else 'row_major'} on CUDA")

    bits = repeat_bits(device, runs["b_two_sided"][0])
    log("constrained (b) final BA solved twice from the same input: " + json.dumps(bits))
    solver_checks(device, canonical_volume)
    gap_rot, gap_center = small_two_sided_card_vs_cpu(device)
    log(f"constrained two_sided_ring_scene(): the card within {gap_rot:.3e} deg and {gap_center * 1e3:.4f} mm of the CPU run")
    if not (gap_rot <= CARD_VS_CPU_ROTATION_DEG and gap_center <= CARD_VS_CPU_CENTER_M):
        raise AssertionError(f"constrained: the card's two-sided 6 x 24 rig differs from the CPU's by {gap_rot} deg, {gap_center} m")
    return launches, runs["c_static_markers"][1].capture_volume


# ---------------------------------------------------------------------------
# Intrinsic phase
# ---------------------------------------------------------------------------


def targets_common():
    """The port tests' numpy renderers of the targets (tests/torch_targets_common.py)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_targets_common

    return torch_targets_common


def intrinsic_observations(K, dist, fisheye, n, rng, cam_id, tilt=(0.1, 0.9), axis=None):
    """n candidate frames of one camera by the JAX suite's single-camera
    recipe (tests/test_intrinsics.py:14-61; a random tilt axis unless `axis`
    fixes it) through the port's projection on float64 CPU tensors:
    (sync, cam, object, keypoint, img, obj) columns."""
    import numpy as np
    import torch

    from caliscope_tpu_torch.ops.projection import project_points

    xs, ys = np.meshgrid(np.arange(7), np.arange(5))
    board = np.zeros((35, 3))
    board[:, 0], board[:, 1] = xs.ravel() * 0.054, ys.ravel() * 0.054
    board -= board.mean(axis=0)
    w, h = INTR_WH
    args = [torch.tensor(a, dtype=torch.float64) for a in (board, K, dist)]
    rows, f = [], 0
    while len(rows) < n:
        u = rng.normal(size=3) if axis is None else np.asarray(axis, np.float64)
        rvec = u / np.linalg.norm(u) * rng.uniform(*tilt)
        t = np.array([rng.uniform(-0.25, 0.25), rng.uniform(-0.15, 0.15), rng.uniform(0.4, 1.2)])
        uv = project_points(args[0], torch.tensor(rvec), torch.tensor(t), args[1], args[2], fisheye).numpy()
        uv = uv + rng.normal(scale=INTR_NOISE_PX, size=uv.shape)
        vis = (uv[:, 0] > 5) & (uv[:, 0] < w - 5) & (uv[:, 1] > 5) & (uv[:, 1] < h - 5)
        if vis.sum() >= 6:
            rows.append((np.full(vis.sum(), f), np.flatnonzero(vis), uv[vis], board[vis]))
        f += 1
    sync_, kp, img, obj = (np.concatenate(c) for c in zip(*rows))
    return sync_, np.full(len(sync_), cam_id), np.zeros(len(sync_), np.int64), kp, img, obj


def _k_gap(got, want):
    """Largest relative difference of fx, fy, cx, cy."""
    import numpy as np

    idx = ([0, 1, 0, 1], [0, 1, 2, 2])
    return float(np.max(np.abs(got[idx] - want[idx]) / np.abs(want[idx])))


def jacobian_times(ip, cam_id, selected, fisheye, device):
    """The intrinsic LM's J at one camera's selected frames, in float64: the
    closed form (`_jacobian`) against torch.func.jacfwd of the residuals,
    ms a call on `device` (CUDA events) and on the host's CPU (wall)."""
    import numpy as np
    import torch

    from caliscope_tpu_torch.ops.bucket import bucket_size
    from caliscope_tpu_torch.pipelines.calibrate_intrinsics import _pack_frames
    from caliscope_tpu_torch.solvers.intrinsics import _jacobian, _residuals

    obj, img, mask = _pack_frames(ip, cam_id, selected)
    F, Kc = bucket_size(obj.shape[0], floor=8), bucket_size(obj.shape[1], floor=8)
    pads = ((0, F - obj.shape[0]), (0, Kc - obj.shape[1]))
    obj, img, mask = np.pad(obj, pads + ((0, 0),)), np.pad(img, pads + ((0, 0),)), np.pad(mask, pads)
    n_dist = 4 if fisheye else 5
    params = np.concatenate([[1400.0, 1400.0, 960.0, 540.0], [-0.2, 0.05, 0.001, -0.001, 0.01][:n_dist], np.tile([0.1, 0.2, 0.1, 0.0, 0.0, 0.8], F)])
    out = {}
    for dev in [device] + ([torch.device("cpu")] if device.type == "cuda" else []):
        p, o, i, m = (torch.as_tensor(a, dtype=torch.float64, device=dev) for a in (params, obj, img, mask))
        closed = lambda: _jacobian(p, o, m, n_dist, fisheye, False)  # noqa: E731
        fwd = lambda: torch.func.jacfwd(lambda q: _residuals(q, o, i, m, n_dist, fisheye, False).reshape(-1))(p)  # noqa: E731
        want = fwd()
        if not torch.allclose(closed(), want, rtol=1e-10, atol=1e-10 * float(want.abs().max())):
            raise AssertionError(f"intrinsics (a): the closed-form J differs from jacfwd on {dev}")
        for name, fn in (("closed", closed), ("jacfwd", fwd)):
            if dev.type == "cuda":
                out[f"{name}_{dev.type}_ms"] = time_ms(fn, reps=5, rounds=3)
            else:
                fn()
                t0 = time.perf_counter()
                for _ in range(3):
                    fn()
                out[f"{name}_{dev.type}_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    log(f"intrinsics (a) camera {cam_id}: J ({F * Kc * 2} x {9 + 6 * F}, float64) a call, equal within 1e-10: "
        + "; ".join(f"closed form {out[f'closed_{t}_ms']:.3f} ms, jacfwd {out[f'jacfwd_{t}_ms']:.3f} ms on "
                    + ("the card (CUDA events)" if t == "cuda" else "the host's CPU (wall)") for t in ("cuda", "cpu") if f"closed_{t}_ms" in out))
    return out


def intrinsics_from_observations(device):
    """(a): 8 cameras x 600 candidate frames through run_intrinsic_calibration
    on `device` (float64, the default), each against its truth, a float32
    solve and, for camera 0, the port's CPU run; camera 0's J both ways."""
    import numpy as np
    import torch

    from caliscope_tpu_torch import CameraData, ImagePoints
    from caliscope_tpu_torch.frame_selector import select_calibration_frames
    from caliscope_tpu_torch.pipelines import run_intrinsic_calibration
    from caliscope_tpu_torch.synthetic.factories import default_ring_scene

    ring = default_ring_scene(n_cameras=8, n_frames=1).cameras.cameras
    truths = [(ring[c].matrix, ring[c].distortions, False) for c in range(INTR_N_BROWN)]
    truths += [(np.array(INTR_FISHEYE_K), np.array(INTR_FISHEYE_DIST), True)] * INTR_N_FISHEYE
    rng = np.random.default_rng(INTR_SEED)
    t0 = time.perf_counter()
    cols = [intrinsic_observations(K, d, fe, INTR_CANDIDATES, rng, cid) for cid, (K, d, fe) in enumerate(truths)]
    ip = ImagePoints(*(np.concatenate(c) for c in zip(*cols)))
    log(f"intrinsics (a): {len(truths)} cameras x {INTR_CANDIDATES} candidate frames, {len(ip)} observations made in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    worst = {"focal": 0.0, "pp": 0.0, "k1": 0.0, "rmse": 0.0, "f32_k": 0.0, "f32_dist": 0.0}
    seconds = {"run": 0.0, "solve": 0.0, "solve_f32": 0.0}
    for cid, (K, d, fe) in enumerate(truths):
        cam = CameraData(cam_id=cid, size=INTR_WH, fisheye=fe)
        t0 = time.perf_counter()
        _, coverage = select_calibration_frames(ip, cid, INTR_WH)  # its own call, for the candidate count
        select_s = time.perf_counter() - t0
        sync(device)
        t0 = time.perf_counter()
        out = run_intrinsic_calibration(ip, cam, device=device)
        sync(device)
        run_s = time.perf_counter() - t0
        f32 = run_intrinsic_calibration(ip, cam, device=device, dtype=torch.float32)
        Kc, dc, sv, s32 = out.camera.matrix, out.camera.distortions, out.solve, f32.solve
        focal = max(abs(Kc[i, i] - K[i, i]) / K[i, i] for i in (0, 1))
        pp = float(np.abs(Kc[:2, 2] - K[:2, 2]).max())
        k1 = abs(dc[0] - d[0])
        f32_k, f32_d = _k_gap(f32.camera.matrix, Kc), float(np.abs(f32.camera.distortions - dc).max())
        for key, v in (("focal", focal), ("pp", pp), ("k1", k1), ("rmse", out.report.rmse), ("f32_k", f32_k), ("f32_dist", f32_d)):
            worst[key] = max(worst[key], float(v))
        for key, v in (("run", run_s), ("solve", sv.seconds), ("solve_f32", s32.seconds)):
            seconds[key] += v
        log(
            f"intrinsics (a) camera {cid} ({'fisheye' if fe else 'Brown'}): {coverage.n_candidate_frames} candidates, "
            f"{out.report.frames_used} selected (F bucketed {sv.n_frames_bucketed}), {sv.n_iterations} LM iterations "
            f"(converged {sv.converged}), restart {'taken' if sv.restarted else 'not taken'}, {sv.host_reads} host reads; "
            f"the run {run_s:.3f} s, its solve {sv.seconds:.3f} s (selection alone {select_s:.3f} s); fx {Kc[0, 0]:.3f} fy "
            f"{Kc[1, 1]:.3f} cx {Kc[0, 2]:.3f} cy {Kc[1, 2]:.3f} k1 {dc[0]:.5f}; focal error {100 * focal:.4f} %, "
            f"principal point {pp:.3f} px, k1 {k1:.5f}, RMSE {out.report.rmse:.4f} px; a float32 solve: {s32.n_iterations} "
            f"LM iterations (converged {s32.converged}), {s32.seconds:.3f} s, against float64 K {f32_k:.2e} relative, "
            f"distortion {f32_d:.2e}"
        )
        if not (focal < FOCAL_RTOL and pp < PP_ATOL_PX and k1 < K1_ATOL[fe] and out.report.rmse < MAX_INTR_RMSE_PX):
            raise AssertionError(f"intrinsics (a) camera {cid}: focal {focal:.4f}, principal point {pp:.2f} px, k1 {k1:.4f}, "
                                 f"RMSE {out.report.rmse:.3f} px against the gates {FOCAL_RTOL}, {PP_ATOL_PX}, {K1_ATOL[fe]}, {MAX_INTR_RMSE_PX}")
        if not (f32_k <= F32_K_RTOL and f32_d <= F32_DIST_ATOL):
            raise AssertionError(f"intrinsics (a) camera {cid}: float32 and float64 solves part by {f32_k:.2e} (K) / {f32_d:.2e} (distortion)")
        if cid == 0:
            t0 = time.perf_counter()
            cpu = run_intrinsic_calibration(ip, cam, device="cpu")
            cpu_s = time.perf_counter() - t0
            gap_k, gap_d = _k_gap(Kc, cpu.camera.matrix), float(np.abs(dc - cpu.camera.distortions).max())
            log(f"intrinsics (a) camera 0: the card's run against the port's CPU run ({cpu_s:.2f} s, its solve "
                f"{cpu.solve.seconds:.3f} s, {cpu.solve.n_iterations} LM iterations): K {gap_k:.2e} relative, distortion {gap_d:.2e}")
            if not (gap_k <= F32_K_RTOL and gap_d <= F32_DIST_ATOL):
                raise AssertionError(f"intrinsics (a): the card parts from the CPU by {gap_k:.2e} (K) / {gap_d:.2e} (distortion)")
            jacobian_times(ip, cid, list(out.report.selected_frames), fe, device)
    log("intrinsics (a): worst over the cameras " + json.dumps({k: float(f"{v:.6g}") for k, v in worst.items()}))
    log(f"intrinsics (a): {len(truths)} runs {seconds['run']:.3f} s, their float64 solves {seconds['solve']:.3f} s; "
        f"the {len(truths)} float32 solves {seconds['solve_f32']:.3f} s")


def starved_camera(device):
    """(a'): every candidate tilted about the same axis (the board's x
    axis), so its perspective falls in fewer than four orientation bins of
    the selector and the selection keeps every candidate."""
    import numpy as np
    import torch

    from caliscope_tpu_torch import CameraData, ImagePoints
    from caliscope_tpu_torch.pipelines import run_intrinsic_calibration
    from caliscope_tpu_torch.synthetic.factories import default_ring_scene

    truth = default_ring_scene(n_cameras=1, n_frames=1).cameras.cameras[0]
    rng = np.random.default_rng(INTR_SEED + 1)
    ip = ImagePoints(*intrinsic_observations(truth.matrix, truth.distortions, False, STARVED_CANDIDATES, rng, 0, tilt=(0.3, 0.6), axis=(1, 0, 0)))
    cam = CameraData(cam_id=0, size=INTR_WH)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sync(device)
    t0 = time.perf_counter()
    out = run_intrinsic_calibration(ip, cam, device=device)
    sync(device)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    sv = out.solve
    F, n_params = sv.n_frames_bucketed, 9 + 6 * sv.n_frames_bucketed
    j_bytes = F * 64 * 2 * n_params * 8  # rows: F x 64 corners (35, bucketed) x 2; float64
    finite = np.isfinite(out.camera.matrix).all() and np.isfinite(out.camera.distortions).all() and np.isfinite(out.report.rmse)
    log(
        f"intrinsics (a') orientation-starved camera: {STARVED_CANDIDATES} candidates tilted about one axis, {out.report.frames_used} "
        f"selected (orientation bins {out.report.orientation_count}), F = {F}, {n_params} parameters, J {j_bytes / 1e6:.1f} MB "
        f"in float64, {sv.n_iterations} LM iterations (converged {sv.converged}, restart "
        f"{'taken' if sv.restarted else 'not taken'}), {sv.host_reads} host reads, {seconds:.3f} s (the solve "
        f"{sv.seconds:.3f} s), peak device memory "
        f"{'not measured' if peak is None else f'{peak / 1e6:.1f} MB'}; fx {out.camera.matrix[0, 0]:.2f} "
        f"(truth {truth.matrix[0, 0]:.0f}), RMSE {out.report.rmse:.4f} px"
    )
    if out.report.frames_used != STARVED_CANDIDATES or len(out.report.selected_frames) != STARVED_CANDIDATES or not finite:
        raise AssertionError(f"intrinsics (a'): {out.report.frames_used} of {STARVED_CANDIDATES} frames used, finite {finite}")


def _zero_detect_counts():
    from caliscope_tpu_torch.detect import ccl as CCL
    from caliscope_tpu_torch.detect import cuda_kernels as CK

    CCL.connected_components.launches = CK.corner_response.launches = CK.extract_windows.launches = 0
    CCL.connected_components.resident_launches = 0


def _detect_counts():
    """(ccl, response, windows) launches and the resident labelings."""
    from caliscope_tpu_torch.detect import ccl as CCL
    from caliscope_tpu_torch.detect import cuda_kernels as CK

    return (CCL.connected_components.launches, CK.corner_response.launches, CK.extract_windows.launches), CCL.connected_components.resident_launches


_record_lock = threading.Lock()  # the recorders below may be called from one thread a camera


@contextmanager
def recorded_gathers(store):
    """Route the detection modules' calls of kernel 4 (detect/kernels.py's
    atlas gather, detect/corners.py's corner windows) through a recorder:
    `store["calls"]` counts their CUDA calls, and `store[(frames shape, K,
    win)]` keeps the inputs of the first CUDA call of each shape, so each
    shape a path gave the kernel can be held against the plain version;
    `store["tma_calls"]` counts the calls the path rule sent to the TMA
    path (a clone keeps its shape, not its alignment, so the rule is read
    on the caller's tensor)."""
    from caliscope_tpu_torch.detect import corners as DC
    from caliscope_tpu_torch.detect import cuda_kernels as CK
    from caliscope_tpu_torch.detect import kernels as DK

    def record(frames, yi, xi, win):
        if frames.is_cuda:
            key = (tuple(frames.shape), int(yi.shape[1]), int(win))
            path = CK.windows_path(frames, win)
            with _record_lock:
                store["calls"] = store.get("calls", 0) + 1
                store["tma_calls"] = store.get("tma_calls", 0) + (path == "tma")
                if key not in store:
                    store[key] = (frames.clone(), yi.clone(), xi.clone(), win)
        return CK.extract_windows(frames, yi, xi, win)

    saved = DC.extract_windows, DK.extract_windows
    DC.extract_windows = DK.extract_windows = record
    try:
        yield store
    finally:
        DC.extract_windows, DK.extract_windows = saved


# the TMA-path launches of kernel 4 in each recorded run, by the run's name
# (check_recorded_gathers), for the kernels line
TMA_LAUNCHES_BY_RUN = {}


def check_recorded_gathers(store, launches, what):
    """Every kernel-4 launch of the run went through the recorder, and the
    kernel equals its plain version (torch.equal) at each shape recorded,
    on the path the rule picks there (the recorded frames are fresh
    allocations, so aligned as the callers' are). Keeps the run's TMA
    launches in TMA_LAUNCHES_BY_RUN[what]. Returns the shapes, "(B, K,
    win) on (B, H, W) path"."""
    import torch

    from caliscope_tpu_torch.detect import cuda_kernels as CK

    if store.get("calls", 0) != launches:
        raise AssertionError(f"{what}: {launches} window-gather launches, {store.get('calls', 0)} recorded")
    shapes = []
    for key, args in store.items():
        if not isinstance(key, tuple):
            continue
        if not torch.equal(CK.extract_windows(*args), CK.extract_windows_plain(*args)):
            raise AssertionError(f"{what}: extract_windows at {key} differs from the plain version")
        shapes.append(f"({key[0][0]}, {key[1]}, {key[2]}) on {key[0]} {CK.windows_path(args[0], args[3])}")
    TMA_LAUNCHES_BY_RUN[what] = store.get("tma_calls", 0)
    log(f"{what}: extract_windows equal to the plain version (torch.equal) at every shape the run gave it: " + ", ".join(shapes)
        + f"; {TMA_LAUNCHES_BY_RUN[what]} of its {launches} launches on the TMA path")
    return shapes


@contextmanager
def recorded_detect_kernels(store):
    """recorded_gathers into store["windows"], and the detection modules'
    calls of kernels 2 and 3 (detect/aruco.py's labeling, detect/corners.py's
    response) likewise into store["ccl"] and store["response"]: each counts
    its CUDA calls under "calls" and keeps the inputs of the first CUDA call
    of each (shape, n_iters) or shape."""
    from caliscope_tpu_torch.detect import aruco as DA
    from caliscope_tpu_torch.detect import ccl as CCL
    from caliscope_tpu_torch.detect import corners as DC
    from caliscope_tpu_torch.detect import cuda_kernels as CK

    ccl_store, resp_store = store.setdefault("ccl", {}), store.setdefault("response", {})

    def keep(sub, key, args):
        with _record_lock:
            sub["calls"] = sub.get("calls", 0) + 1
            if key not in sub:
                sub[key] = tuple(a.clone() if hasattr(a, "clone") else a for a in args)

    def ccl(mask, n_iters=4):
        if mask.is_cuda:
            keep(ccl_store, (tuple(mask.shape), int(n_iters)), (mask, n_iters))
        return CCL.connected_components(mask, n_iters)

    def response(images):
        if images.is_cuda:
            keep(resp_store, tuple(images.shape), (images,))
        return CK.corner_response(images)

    saved = DA.connected_components, DC.corner_response
    DA.connected_components, DC.corner_response = ccl, response
    try:
        with recorded_gathers(store.setdefault("windows", {})):
            yield store
    finally:
        DA.connected_components, DC.corner_response = saved


def check_recorded_detect_kernels(store, launches, what):
    """check_recorded_gathers for kernel 4, and for kernels 2 and 3: every
    launch of the run went through the recorder, and the kernel equals its
    plain version (torch.equal) at each shape recorded. launches = (ccl,
    response, windows) of the run. Returns {kernel: shapes}."""
    import torch

    from caliscope_tpu_torch.detect import ccl as CCL
    from caliscope_tpu_torch.detect import cuda_kernels as CK

    before = _detect_counts()
    shapes = {}
    for name, n, sub, kernel, plain in (
        ("ccl", launches[0], store["ccl"], CCL.connected_components, CCL.connected_components_plain),
        ("corner_response", launches[1], store["response"], CK.corner_response, CK.corner_response_plain),
    ):
        if sub.get("calls", 0) != n:
            raise AssertionError(f"{what}: {n} {name} launches, {sub.get('calls', 0)} recorded")
        shapes[name] = []
        for key, args in sub.items():
            if key == "calls":
                continue
            if not torch.equal(kernel(*args), plain(*args)):
                raise AssertionError(f"{what}: {name} at {key} differs from the plain version")
            shapes[name].append(str(key))
        log(f"{what}: {name} equal to the plain version (torch.equal) at every shape the run gave it: " + ", ".join(shapes[name]))
    shapes["extract_windows"] = check_recorded_gathers(store["windows"], launches[2], what)
    (CCL.connected_components.launches, CK.corner_response.launches, CK.extract_windows.launches), CCL.connected_components.resident_launches = before
    return shapes


def _packets_to_points(packets):
    import numpy as np

    from caliscope_tpu_torch import ImagePoints

    n = sum(len(p) for p in packets)
    return ImagePoints(
        np.concatenate([np.full(len(p), i) for i, p in enumerate(packets)]), np.zeros(n, np.int64),
        np.concatenate([p.object_id for p in packets]), np.concatenate([p.keypoint_id for p in packets]),
        np.concatenate([p.img_loc for p in packets]), np.concatenate([p.obj_loc for p in packets]),
    )


def intrinsics_from_frames(device, tc):
    """(b): rendered ChArUco frames -> CharucoTracker -> run_intrinsic_calibration.
    Returns the kernels' launches (ccl, response, windows) on the path."""
    import numpy as np

    from caliscope_tpu_torch import CameraData
    from caliscope_tpu_torch.pipelines import run_intrinsic_calibration
    from caliscope_tpu_torch.targets.charuco import Charuco
    from caliscope_tpu_torch.trackers import CharucoTracker

    ch = Charuco(rows=5, columns=7, square_size_m=0.054)
    K = np.array(K_TRUE)
    t0 = time.perf_counter()
    frames, truth = tc.posed_board_views(ch, 100, K, DETECT_WH, FRAMES_FOR_INTRINSICS, seed=INTR_SEED)
    render_s = time.perf_counter() - t0
    tracker = CharucoTracker(ch, device=device)
    tracker.get_points_batch(frames[:8], 0)  # warm-up
    _zero_detect_counts()
    before = tracker.dispatches
    sync(device)
    with recorded_gathers({}) as gathers:
        t0 = time.perf_counter()
        packets = tracker.get_points_batch(frames, 0)
        sync(device)
        detect_s = time.perf_counter() - t0
    launches, resident = _detect_counts()
    dispatches = tracker.dispatches - before
    errs = np.concatenate([np.linalg.norm(p.img_loc - gt[p.keypoint_id], axis=1) for p, gt in zip(packets, truth)])
    t0 = time.perf_counter()
    out = run_intrinsic_calibration(_packets_to_points(packets), CameraData(cam_id=0, size=DETECT_WH), device=device)
    sync(device)
    calib_s = time.perf_counter() - t0
    Kc, dc, sv = out.camera.matrix, out.camera.distortions, out.solve
    focal = max(abs(Kc[i, i] - K[i, i]) / K[i, i] for i in (0, 1))
    pp = float(np.abs(Kc[:2, 2] - K[:2, 2]).max())
    log(
        f"intrinsics (b) from frames: {len(frames)} ChArUco frames {DETECT_WH[0]}x{DETECT_WH[1]} rendered in {render_s:.2f} s "
        f"(host); CharucoTracker.get_points_batch {detect_s:.3f} s on {device}: {len(errs)} corners "
        f"(error mean {errs.mean():.4f} px, max {errs.max():.4f} px), {dispatches} dispatches, launches ccl {launches[0]} "
        f"(resident {resident}) response {launches[1]} windows {launches[2]}; run_intrinsic_calibration {calib_s:.3f} s "
        f"(the solve {sv.seconds:.3f} s): {out.report.frames_used} frames (F bucketed {sv.n_frames_bucketed}), "
        f"{sv.n_iterations} LM iterations (converged {sv.converged}), restart "
        f"{'taken' if sv.restarted else 'not taken'}, {sv.host_reads} host reads; fx {Kc[0, 0]:.3f} fy {Kc[1, 1]:.3f} cx "
        f"{Kc[0, 2]:.3f} cy {Kc[1, 2]:.3f} k1 {dc[0]:.5f} against K_TRUE {K_TRUE[0][0]}/{K_TRUE[1][1]}/{K_TRUE[0][2]}/{K_TRUE[1][2]}: "
        f"focal {100 * focal:.4f} %, principal point {pp:.3f} px, RMSE {out.report.rmse:.4f} px"
    )
    if device.type == "cuda" and (launches != (dispatches, dispatches, 2 * dispatches) or resident != dispatches):
        raise AssertionError(f"intrinsics (b): launches {launches} (resident {resident}) for {dispatches} dispatches")
    if device.type == "cuda":
        check_recorded_gathers(gathers, launches[2], "intrinsics (b)")
    if not (focal < FOCAL_RTOL and pp < PP_ATOL_PX and abs(dc[0]) < K1_ATOL[False] and errs.mean() < MAX_MEAN_CORNER_ERROR_PX):
        raise AssertionError(f"intrinsics (b): focal {focal:.4f}, principal point {pp:.2f} px, k1 {dc[0]:.4f}, corner error {errs.mean():.3f} px")
    return launches


def _card_vs_cpu(got, want, what):
    import numpy as np

    for i, (g, w) in enumerate(zip(got, want)):
        if not (np.array_equal(g.object_id, w.object_id) and np.array_equal(g.keypoint_id, w.keypoint_id)):
            raise AssertionError(f"{what} frame {i}: the card's ids differ from the CPU's")
        if len(w) and np.abs(g.img_loc - w.img_loc).max() > GPU_VS_CPU_ATOL_PX:
            raise AssertionError(f"{what} frame {i}: the card's corners part from the CPU's by {np.abs(g.img_loc - w.img_loc).max():.3e} px")
    return max((float(np.abs(g.img_loc - w.img_loc).max()) for g, w in zip(got, want) if len(w)), default=0.0)


def chessboard_views(tc, seed, tilt=(0.1, 0.9)):
    """TRACKER_FRAMES views of the 6x8-square chessboard (60 px squares of
    30 mm) through K_TRUE at the recipe's poses: (frames, homographies sheet
    pixels -> frame, the inner corners in sheet pixels)."""
    import numpy as np

    sheet, xy = tc.chessboard_sheet(6, 8, 60, 30)
    px_to_m = np.array([[0.03 / 60, 0.0], [0.0, 0.03 / 60], [0.0, 0.0]])
    frames, Hs = tc.posed_views(sheet, px_to_m, np.array(K_TRUE), DETECT_WH, TRACKER_FRAMES, seed=seed, tilt=tilt)
    return frames, Hs, xy


def chessboard_path(device, tc):
    """(c) chessboard: 16 frames, one a call, on the card and on the CPU.
    Returns (launches, the frames, the frames of the full tilt range)."""
    import numpy as np

    from caliscope_tpu_torch.targets import Chessboard, render
    from caliscope_tpu_torch.trackers import ChessboardTracker

    frames, Hs, xy = chessboard_views(tc, INTR_SEED + 2, CHESS_TILT)
    board = Chessboard(5, 7, 0.03)
    tracker = ChessboardTracker(board, device=device)
    tracker.get_points(frames[0])  # warm-up
    _zero_detect_counts()
    sync(device)
    with recorded_gathers({}) as gathers:
        t0 = time.perf_counter()
        packets = [tracker.get_points(f) for f in frames]
        sync(device)
        seconds = time.perf_counter() - t0
    launches, _ = _detect_counts()
    complete = sum(len(p) == board.n_corners for p in packets)
    errs = [tc.grid_error(p.img_loc, p.keypoint_id, render.project(H, xy), 5, 7) for p, H in zip(packets, Hs) if len(p)]
    cpu_tracker = ChessboardTracker(board, device="cpu")
    gap = _card_vs_cpu(packets, [cpu_tracker.get_points(f) for f in frames], "chessboard")
    wide, _, _ = chessboard_views(tc, CHESS_WIDE_SEED)
    wide_card = [tracker.get_points(f) for f in wide]
    _card_vs_cpu(wide_card, [cpu_tracker.get_points(f) for f in wide], "chessboard (tilt 0.1-0.9 rad)")
    wide_corners = tuple(len(p) for p in wide_card)
    log(
        f"chessboard tracker: {len(frames)} frames {DETECT_WH[0]}x{DETECT_WH[1]} (tilt {CHESS_TILT[0]}-{CHESS_TILT[1]} rad) one a call, "
        f"{seconds:.3f} s on {device} ({1e3 * seconds / len(frames):.1f} ms a frame): {complete} complete grids, corner "
        f"error mean {np.mean(errs):.4f} px (worst frame {np.max(errs):.4f}); launches ccl {launches[0]} response "
        f"{launches[1]} windows {launches[2]}; the card within {gap:.2e} px of the CPU; at the recipe's tilt of 0.1-0.9 rad "
        f"{sum(len(p) == board.n_corners for p in wide_card)} of {len(wide)} views complete, the same views as on the CPU "
        f"and as the JAX package's tracker"
    )
    if wide_corners != CHESS_WIDE_CORNERS:
        raise AssertionError(f"chessboard (tilt 0.1-0.9 rad): corners a view {wide_corners}, the JAX package's {CHESS_WIDE_CORNERS}")
    if complete != len(frames) or np.mean(errs) >= MAX_MEAN_CORNER_ERROR_PX:
        raise AssertionError(f"chessboard: {complete} of {len(frames)} grids complete, mean corner error {np.mean(errs):.3f} px")
    if device.type == "cuda" and launches != (0, len(frames), 2 * len(frames)):
        raise AssertionError(f"chessboard: launches {launches} for {len(frames)} frames (a response and two window gathers each)")
    if device.type == "cuda":
        check_recorded_gathers(gathers, launches[2], "chessboard")
    return launches, frames


def aruco_path(device, tc):
    """(c) ArUco: 16 frames of three markers, one a call. Returns (launches, frames)."""
    import numpy as np

    from caliscope_tpu_torch.targets import ArucoMarker, ArucoMarkerSet, render
    from caliscope_tpu_torch.trackers import ArucoTracker

    K = np.array(K_TRUE)
    sheet, corners = tc.marker_sheet("DICT_4X4_50", [(3, 60, 60), (17, 500, 80), (44, 260, 380)], (840, 640), 30)
    px_to_m = np.array([[0.1 / 180, 0.0], [0.0, 0.1 / 180], [0.0, 0.0]])  # 180 px markers of 0.1 m
    frames, Hs = tc.posed_views(sheet, px_to_m, K, DETECT_WH, TRACKER_FRAMES, seed=INTR_SEED + 3)
    tracker = ArucoTracker(ArucoMarkerSet("DICT_4X4_50", {i: ArucoMarker(i, 0.1) for i in MARKER_IDS}), device=device)
    tracker.get_points(frames[0])  # warm-up
    _zero_detect_counts()
    sync(device)
    with recorded_gathers({}) as gathers:
        t0 = time.perf_counter()
        packets = [tracker.get_points(f) for f in frames]
        sync(device)
        seconds = time.perf_counter() - t0
    launches, resident = _detect_counts()
    errs = []
    for i, (p, H) in enumerate(zip(packets, Hs)):
        ids = sorted(set(p.object_id.tolist()))
        kps = {m: sorted(p.keypoint_id[p.object_id == m].tolist()) for m in ids}
        if ids != list(MARKER_IDS) or any(k != [0, 1, 2, 3] for k in kps.values()):
            raise AssertionError(f"aruco frame {i}: ids {ids}, keypoints {kps}")
        truth = {m: render.project(H, c) for m, c in corners.items()}
        errs.append(float(np.mean([np.linalg.norm(p.img_loc[j] - truth[int(m)][int(k)]) for j, (m, k) in enumerate(zip(p.object_id, p.keypoint_id))])))
    gap = _card_vs_cpu(packets, [ArucoTracker(tracker.marker_set, device="cpu").get_points(f) for f in frames], "aruco")
    log(
        f"aruco tracker: {len(frames)} frames {DETECT_WH[0]}x{DETECT_WH[1]} of {len(MARKER_IDS)} markers one a call, {seconds:.3f} s "
        f"on {device} ({1e3 * seconds / len(frames):.1f} ms a frame): every id and corner found, corner error mean "
        f"{np.mean(errs):.4f} px (worst frame {np.max(errs):.4f}); launches ccl {launches[0]} (resident {resident}) response "
        f"{launches[1]} windows {launches[2]}; the card within {gap:.2e} px of the CPU"
    )
    if np.mean(errs) >= MAX_MEAN_CORNER_ERROR_PX:
        raise AssertionError(f"aruco: mean corner error {np.mean(errs):.3f} px")
    if device.type == "cuda" and (launches != (len(frames), 0, len(frames)) or resident != len(frames)):
        raise AssertionError(f"aruco: launches {launches} (resident {resident}) for {len(frames)} frames")
    if device.type == "cuda":
        check_recorded_gathers(gathers, launches[2], "aruco")
    return launches, frames


def tracker_kernel_checks(device, peaks, chess_frame, aruco_frame):
    """Kernels 2-4 against their plain versions at the trackers' shapes (B =
    1; the chessboard's K = 512 corner windows of 28 x 28), with times and
    bounds there. Returns {kernel: the entry's `tracker_shapes` record}."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from caliscope_tpu_torch.detect import ccl as CCL
    from caliscope_tpu_torch.detect import cuda_kernels as CK
    from caliscope_tpu_torch.detect import kernels as DK
    from caliscope_tpu_torch.detect.corners import nms_corners

    counts = _detect_counts()
    imgs = torch.from_numpy(chess_frame[None].astype(np.float32)).to(device)
    _, H, W = imgs.shape
    resp = CK.corner_response(imgs)
    if not torch.equal(resp, CK.corner_response_plain(imgs)):
        raise AssertionError("corner_response at B = 1: differs from the plain version")
    xy, _, _ = nms_corners(resp, 512)
    win, pad = 28, 14  # refine_corners_subpix at win 5, 4 iterations
    padded = F.pad(imgs[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0].contiguous()
    xi = torch.clamp(torch.round(xy[..., 0]).to(torch.int32) - win // 2 + pad, 0, W + 2 * pad - win).contiguous()
    yi = torch.clamp(torch.round(xy[..., 1]).to(torch.int32) - win // 2 + pad, 0, H + 2 * pad - win).contiguous()
    if not torch.equal(CK.extract_windows(padded, yi, xi, win), CK.extract_windows_plain(padded, yi, xi, win)):
        raise AssertionError("extract_windows at K = 512, win 28: differs from the plain version")
    a = torch.from_numpy(aruco_frame[None].astype(np.float32)).to(device)
    integral = DK.integral_image(a)
    mask = (DK.adaptive_threshold(a, 10, 7.0, integral) | DK.adaptive_threshold(a, 26, 7.0, integral)).contiguous()
    if not torch.equal(CCL.connected_components(mask, 4), CCL.connected_components_plain(mask, 4)):
        raise AssertionError("ccl at B = 1: differs from the plain version")
    log("kernels at the trackers' shapes: corner_response (1,720,1280), extract_windows (1,748,1308) K=512 win=28 and ccl "
        "(1,720,1280) each equal to the plain version (torch.equal)")
    ar = torch.arange(win, device=device)
    yy, xx = yi.long()[:, :, None, None] + ar[:, None], xi.long()[:, :, None, None] + ar[None, :]
    ops_px, _ = response_ops_per_pixel()
    out = {}
    for name, fn, plain, lib, bytes_, ops, what, rate in (
        ("ccl", lambda: CCL.connected_components(mask, 4), lambda: CCL.connected_components_plain(mask, 4), None,
         H * W * 5, H * W * 2 * 4, "(1,720,1280) bool, n_iters=4", None),
        ("corner_response", lambda: CK.corner_response(imgs), lambda: CK.corner_response_plain(imgs), None,
         H * W * 8, H * W * ops_px, "(1,720,1280) f32", peaks[2]),
        ("extract_windows", lambda: CK.extract_windows(padded, yi, xi, win), lambda: CK.extract_windows_plain(padded, yi, xi, win),
         lambda: padded[0][yy[0], xx[0]], 512 * (2 * 4 * win * win + 8), 0, "(1,748,1308) f32, K=512, win=28", None),
    ):
        e = bound_entry(name, "", "", 0.0, time_ms(fn), time_ms(plain, reps=3, rounds=3), None if lib is None else time_ms(lib),
                        bytes_, ops, peaks, what + " (the trackers' shape)", op_rate=rate)
        out[name] = {k: e[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")} | {"shape": what}
    (CCL.connected_components.launches, CK.corner_response.launches, CK.extract_windows.launches), CCL.connected_components.resident_launches = counts
    return out


def intrinsic_phase(device, peaks):
    """(a), (a'), (b), (c) and the kernels at the trackers' shapes. Returns
    ({path: (ccl, response, windows) launches}, {kernel: tracker-shape record})."""
    tc = targets_common()
    t0 = time.perf_counter()
    intrinsics_from_observations(device)
    log(f"intrinsics (a): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    starved_camera(device)
    log(f"intrinsics (a'): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    by_path = {"intrinsics_from_frames": intrinsics_from_frames(device, tc)}
    log(f"intrinsics (b): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    by_path["chessboard"], chess_frames = chessboard_path(device, tc)
    by_path["aruco"], aruco_frames = aruco_path(device, tc)
    log(f"trackers (c): {time.perf_counter() - t0:.2f} s")
    shapes = tracker_kernel_checks(device, peaks, chess_frames[0], aruco_frames[0]) if device.type == "cuda" else {}
    return by_path, shapes


# ---------------------------------------------------------------------------
# Markerless: the epipolar bootstrap, reconstruction, pose inference
# ---------------------------------------------------------------------------


def schur_solve_count(rec):
    """The Schur solves of a recorded pipeline run: the LM iterations of its
    BA stages that ran the 'schur' solver ('auto' solves a small problem
    densely)."""
    if len(rec.results) != len(rec.solves):
        raise AssertionError(f"{len(rec.results)} lm_solve calls for {len(rec.solves)} BA stages")
    return sum(s["iterations"] for s, r in zip(rec.solves, rec.results) if r["solver"] == "schur")


def device_costs(device, fn):
    """fn() once more under torch.profiler with CUDA activity only (device
    time: the sum of its GPU kernels' durations; without CPU activity the
    profiler adds little host time) and CUDA's sync debug mode on (one
    warning per synchronising operation it detects). Returns (device s, GPU
    kernels, syncs, wall s)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, profile(activities=[ProfilerActivity.CUDA]) as prof:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            fn()
            sync(device)
            wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e6, len(kernels), syncs, wall


def without_obj_loc(ip):
    import numpy as np

    from caliscope_tpu_torch.observations import ImagePoints

    return ImagePoints(ip.sync_index, ip.cam_id, ip.object_id, ip.keypoint_id, ip.img_xy,
                       np.full((len(ip), 3), np.nan), ip.frame_time)


@contextmanager
def epipolar_stage_clock(seconds):
    """Wall seconds (synchronised) and calls of the epipolar bootstrap's
    steps, summed into `seconds` while the block runs."""
    import torch

    import caliscope_tpu_torch.solvers.epipolar as PE

    saved = {name: getattr(PE, name) for name in EPIPOLAR_PARTS}

    def clocked(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if "device" in kwargs:
                sync(torch.device(kwargs["device"]))
            spent, calls = seconds.get(name, (0.0, 0))
            seconds[name] = (spent + time.perf_counter() - t0, calls + 1)
            return out
        return run

    for name, fn in saved.items():
        setattr(PE, name, clocked(name, fn))
    try:
        yield seconds
    finally:
        for name, fn in saved.items():
            setattr(PE, name, fn)


@contextmanager
def samples_drawn_on_the_cpu():
    """The RANSACs draw their samples from the CPU's generator on every
    device, so that a card run and a CPU run draw the same ones."""
    import caliscope_tpu_torch.ops.epipolar as TE

    draw = TE.sample_indices
    TE.sample_indices = lambda mask, n, k, seed: draw(mask.cpu(), n, k, seed).to(mask.device)
    try:
        yield
    finally:
        TE.sample_indices = draw


def markerless_pipeline(device, ring, ring_ip):
    """(a): default_ring_scene(8, 600) without obj_loc through
    calibrate_extrinsics on the card. Returns (Schur launches, the run, the
    similarity onto the truth, its image points)."""
    import numpy as np
    import torch

    from caliscope_tpu_torch.ops.lie import rotation_geodesic_angle_host
    from caliscope_tpu_torch.ops.similarity import SimilarityParams, umeyama
    from caliscope_tpu_torch.pipelines import calibrate_extrinsics
    from caliscope_tpu_torch.solvers import fused_schur as FS
    from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics
    from caliscope_tpu_torch.synthetic.factories import default_ring_scene
    from caliscope_tpu_torch.volume import CaptureVolume

    ip = without_obj_loc(ring_ip)
    cameras = strip_extrinsics(ring.cameras)
    rec, parts = PipelineRecorder(), {}
    FS.schur_s_rhs.launches = 0  # counts from here on are the markerless pipeline's
    with rec.patched(), epipolar_stage_clock(parts):
        sync(device)
        t0 = time.perf_counter()
        run = calibrate_extrinsics(ip, cameras, None, device=device, progress=rec.progress)
        sync(device)
        seconds = time.perf_counter() - t0
    launches = FS.schur_s_rhs.launches
    volume = run.capture_volume
    n_cams = len(ring.cameras.cameras)
    stages = {k: round(v, 4) for k, v in rec.stage_seconds().items()}
    log(f"markerless (a): default_ring_scene{PIPE_SCENE} without obj_loc, {len(ip)} observations: {seconds:.2f} s "
        f"in all; stage wall seconds {json.dumps(stages)}")
    log("markerless (a) bootstrap steps (wall s, calls): " + json.dumps({k: (round(v[0], 4), v[1]) for k, v in parts.items()}))
    for solve, name in zip(rec.solves, ("linear BA", "robust BA", "final BA")):
        log(f"markerless (a) {name}: " + json.dumps(solve))
    posed_by_boot = len(rec.boot.camera_array.posed_cameras) if rec.boot is not None else 0
    rmse = volume.reprojection_report.overall_rmse
    _aligned, errors = align_to_truth(volume, ring.cameras)
    center = lambda c: -c.rotation.T @ c.translation  # noqa: E731
    posed = sorted(volume.camera_array.posed_cameras)
    sim = umeyama(np.array([center(volume.camera_array.cameras[c]) for c in posed]),
                  np.array([center(ring.cameras.cameras[c]) for c in posed]))
    to_truth = SimilarityParams(float(sim[0]), sim[1].numpy(), sim[2].numpy())
    max_rot = max(e[0] for e in errors.values())
    max_center = max(e[1] for e in errors.values())
    schur_solves = schur_solve_count(rec)
    log(f"markerless (a): {posed_by_boot} of {n_cams} cameras posed by the epipolar bootstrap, final RMSE {rmse:.4f} px, "
        f"against the truth after a similarity (with scale) rotation error max {max_rot:.5f} deg, center error max "
        f"{max_center * 1e3:.4f} mm; schur_s_rhs launches {launches}, Schur solves {schur_solves}")
    if posed_by_boot != n_cams or len(volume.camera_array.posed_cameras) != n_cams:
        raise AssertionError(f"markerless (a): {posed_by_boot} of {n_cams} cameras posed")
    if not rmse < MAX_FINAL_RMSE_PX:
        raise AssertionError(f"markerless (a): final RMSE {rmse:.3f} px")
    if len(errors) != n_cams or not (max_rot <= MAX_PIPE_ROTATION_DEG and max_center <= MAX_PIPE_CENTER_M):
        raise AssertionError(f"markerless (a): rig off the truth: {errors}")
    if len(rec.solves) != 3 or launches < 1 or launches != schur_solves:
        raise AssertionError(f"markerless (a): schur_s_rhs launched {launches} times for {schur_solves} Schur solves")

    device_s, n_kernels, syncs, again_s = device_costs(device, lambda: CaptureVolume.bootstrap(ip, cameras, device=device))
    wall = stages["Bootstrapping poses"]
    log(f"markerless (a) bootstrap: wall {wall:.3f} s (the pipeline's stage), {device_s:.4f} s of device time in "
        f"{n_kernels} GPU kernels, so the device idle {100 * (1 - device_s / wall):.1f} % of the stage (torch.profiler, "
        f"CUDA activity only, a second bootstrap: {again_s:.3f} s under it), {syncs} device->host synchronisations "
        f"(CUDA sync debug mode, a lower bound)")

    # the card against the port's own CPU run on a small ring, the same samples
    small = default_ring_scene(*MARKERLESS_SMALL)
    sip, scams = without_obj_loc(small.image_points_noisy()), strip_extrinsics(small.cameras)
    rigs = {}
    with samples_drawn_on_the_cpu():
        for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
            t0 = time.perf_counter()
            rigs[name], errs = align_to_truth(calibrate_extrinsics(sip, scams, None, device=dev).capture_volume,
                                              small.cameras)
            log(f"markerless (a) {MARKERLESS_SMALL} on {dev.type}: {time.perf_counter() - t0:.2f} s, rotation error max "
                f"{max(e[0] for e in errs.values()):.5f} deg, center error max {max(e[1] for e in errs.values()) * 1e3:.4f} mm")
    gaps = []
    for cid, g in rigs["card"].camera_array.posed_cameras.items():
        c = rigs["cpu"].camera_array.cameras[cid]
        gaps.append((float(np.degrees(rotation_geodesic_angle_host(g.rotation, c.rotation))),
                     float(np.linalg.norm(g.rotation.T @ g.translation - c.rotation.T @ c.translation))))
    gap_rot, gap_center = max(g[0] for g in gaps), max(g[1] for g in gaps)
    log(f"markerless (a) {MARKERLESS_SMALL}: the card within {gap_rot:.3e} deg and {gap_center * 1e3:.4f} mm of the CPU run")
    if len(gaps) != MARKERLESS_SMALL[0] or not (gap_rot <= CARD_VS_CPU_ROTATION_DEG and gap_center <= CARD_VS_CPU_CENTER_M):
        raise AssertionError(f"markerless (a): the card's small rig differs from the CPU's: {gaps}")
    return launches, run, to_truth, ip


class NamedPoints:
    """The tracker surface the exports read, for the board's corners."""

    name = "RING"
    wireframe = None

    def get_point_name(self, keypoint_id):
        return f"corner_{int(keypoint_id):02d}"


def dropped_in_runs(ip, fraction, rng):
    """`ip` without about `fraction` of its rows, dropped per (camera,
    object, keypoint) track in runs of 1-3 consecutive frames."""
    import numpy as np

    n_sync = int(ip.sync_index.max()) + 1
    track = (ip.cam_id * (int(ip.object_id.max()) + 1) + ip.object_id) * (int(ip.keypoint_id.max()) + 1) + ip.keypoint_id
    n_tracks = int(track.max()) + 1
    drop = np.zeros((n_tracks, n_sync + 3), bool)
    n_runs = int(fraction * len(ip) / 2.0)
    starts = rng.integers(0, n_sync, n_runs)
    lengths = rng.integers(1, 4, n_runs)
    tracks = rng.integers(0, n_tracks, n_runs)
    for k in range(3):
        sel = lengths > k
        drop[tracks[sel], starts[sel] + k] = True
    return ip.select(~drop[track, ip.sync_index])


def reconstruction_from(device, ring, volume, to_truth, ip):
    """(b): (a)'s rig and the scene's observations with ~5 % dropped in
    seeded runs -> reconstruct_xyz, WorldPoints.smooth, write_blender_scene."""
    import tempfile

    import numpy as np

    from caliscope_tpu_torch.export import write_blender_scene
    from caliscope_tpu_torch.observations import ImagePoints, WorldPoints
    from caliscope_tpu_torch.reconstruction import reconstruct_xyz

    kept = dropped_in_runs(ip, DROP_FRACTION, np.random.default_rng(SEED))
    steps = {}
    fill, triangulate = ImagePoints.fill_gaps, ImagePoints.triangulate

    def clocked(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(device)
            steps[name] = time.perf_counter() - t0
            return out
        return run

    tracker = NamedPoints()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        ImagePoints.fill_gaps, ImagePoints.triangulate = clocked("fill_gaps", fill), clocked("triangulate", triangulate)
        try:
            t0 = time.perf_counter()
            reconstruct_xyz(kept, volume.camera_array, tracker, out, device=device)
            steps["reconstruct_xyz"] = time.perf_counter() - t0
        finally:
            ImagePoints.fill_gaps, ImagePoints.triangulate = fill, triangulate
        n_filled = len(kept.fill_gaps(3)) - len(kept)
        world = WorldPoints.from_csv(out / "xyz_RING.csv")
        t0 = time.perf_counter()
        smoothed = world.smooth(fps=30.0, cutoff_hz=6.0, device=device)
        sync(device)
        steps["smooth"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        script = write_blender_scene(volume.camera_array, smoothed, out / "scene.py", tracker=tracker)
        steps["write_blender_scene"] = time.perf_counter() - t0
        trc = (out / "xyz_RING.trc").read_bytes().decode().split("\r\n")
        blender_ok = script.exists() and script.with_suffix(".json").exists()
    log(f"markerless (b): {len(ip) - len(kept)} of {len(ip)} observations dropped in runs of 1-3 frames, {n_filled} rows "
        f"filled back, {len(world)} points triangulated; seconds {json.dumps({k: round(v, 4) for k, v in steps.items()})}")
    if not n_filled > 0 or not blender_ok:
        raise AssertionError(f"markerless (b): {n_filled} rows filled, Blender scene written: {blender_ok}")
    # the TRC read back equals the xyz written (to its 6 decimals)
    names = [c for c in trc[3].split("\t")[2:] if c]
    body = [r.split("\t") for r in trc[6:] if r]
    at = {(int(s), int(k)): x for s, k, x in zip(world.sync_index, world.keypoint_id, world.xyz)}
    mismatch = 0
    for row in body:
        for j, name in enumerate(names):
            xyz = at.get((int(row[0]), int(name.split("_")[1])))
            cells = row[2 + 3 * j: 5 + 3 * j]
            want = ["" if xyz is None else str(round(float(v), 6)) for v in (xyz if xyz is not None else (0, 0, 0))]
            mismatch += cells != want
    log(f"markerless (b): TRC {len(body)} frames x {len(names)} markers read back, {mismatch} cells off the xyz written")
    if mismatch or len(body) != len(np.unique(world.sync_index)):
        raise AssertionError("markerless (b): the TRC file does not hold the xyz written")
    # triangulation error to the truth after (a)'s similarity
    truth = ring.world_points()
    tkey = {(int(s), int(o), int(k)): x for s, o, k, x in zip(truth.sync_index, truth.object_id, truth.keypoint_id, truth.xyz)}
    errs = np.array([np.linalg.norm(a - tkey[(int(s), int(o), int(k))]) for s, o, k, a in
                     zip(world.sync_index, world.object_id, world.keypoint_id, to_truth.apply(world.xyz))])
    med = float(np.median(errs))
    log(f"markerless (b): triangulation error to the truth after (a)'s similarity median {med * 1e3:.4f} mm, "
        f"p95 {np.percentile(errs, 95) * 1e3:.4f} mm")
    if not med < MAX_RECON_MEDIAN_M:
        raise AssertionError(f"markerless (b): median triangulation error {med * 1e3:.3f} mm")


def randomized_bn(model):
    """BN with random running statistics, as tests/test_rtmpose_arch.py:33-37."""
    import torch

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    return model


def pose_inference(device, smi_line):
    """(c): RTMPose-m with the Halpe26 card, seeded random weights, exported,
    serialized, re-parsed and run through OnnxTorchSession on the card."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    import caliscope_tpu_torch.pose as pose
    from caliscope_tpu_torch.pose.decode import decode_simcc
    from caliscope_tpu_torch.pose.model_card import ModelCard
    from caliscope_tpu_torch.pose.onnx_proto import parse_model, write_model
    from caliscope_tpu_torch.pose.onnx_torch import OnnxTorchSession
    from caliscope_tpu_torch.pose.onnx_tracker import OnnxTracker
    from caliscope_tpu_torch.pose.rtmpose_arch import RTMPose

    card_path = Path(pose.__file__).parent / "model_cards" / POSE_CARD
    card = ModelCard.from_toml(card_path)
    hw = (card.input_height, card.input_width)
    torch.manual_seed(SEED)
    model = randomized_bn(RTMPose(POSE_VARIANT, len(card.point_name_to_id), hw).eval()).to(device)
    t0 = time.perf_counter()
    raw = write_model(model.export_onnx_model())
    sess = OnnxTorchSession(parse_model(raw), device=device)
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    x = torch.randn(8, 3, *hw, device=device, generator=torch.Generator(device=device).manual_seed(SEED))
    with torch.no_grad():
        want = model(x)
    got = sess.forward({"input": x})
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    close = all(torch.allclose(g, w, atol=POSE_ATOL, rtol=POSE_RTOL) for g, w in zip(got, want))
    kg, _ = decode_simcc(*got)
    kw, _ = decode_simcc(*want)
    kp_gap = float((kg - kw).abs().max())
    log(f"markerless (c): RTMPose-{POSE_VARIANT} with the {card.name} card ({len(card.point_name_to_id)} keypoints, {hw[0]}x{hw[1]}, "
        f"{sum(p.numel() for p in model.parameters())} parameters, {len(raw)} bytes of ONNX, {len(sess.graph.nodes)} nodes) "
        f"exported and parsed in {build_s:.2f} s; OnnxTorchSession vs the module's forward on the card, batch 8: max "
        f"|diff| simcc_x {errs[0]:.3e}, simcc_y {errs[1]:.3e} (atol {POSE_ATOL}, rtol {POSE_RTOL}); decoded keypoints "
        f"within {kp_gap:.4f} px")
    if not close or not kp_gap <= 0.51:
        raise AssertionError("markerless (c): the executor disagrees with the module's forward")
    times = {}
    for b in (1, 8):
        xb = x[:b].contiguous()
        times[f"executor_b{b}_ms"] = time_ms(lambda: sess.forward({"input": xb}), reps=10, rounds=5)
        with torch.no_grad():
            times[f"module_b{b}_ms"] = time_ms(lambda: model(xb), reps=10, rounds=5)
    log(f"markerless (c): ms a call (CUDA events, median of 5 x 10 warm calls) {json.dumps({k: round(v, 4) for k, v in times.items()})} [{smi_line}]")

    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / card.model_path.name).write_bytes(raw)
        tracker = OnnxTracker(ModelCard.from_toml(card_path, models_dir=Path(tmp)), device=device)
        calls = [0]
        forward = tracker._session.forward

        def counted(feeds):
            calls[0] += 1
            return forward(feeds)

        tracker._session.forward = counted
        rng = np.random.default_rng(SEED)
        base = rng.integers(0, 200, (90, 160, 3)).astype(np.uint8)
        frames = [np.ascontiguousarray(np.roll(np.kron(base, np.ones((8, 8, 1), np.uint8)), 16 * i, axis=1))
                  for i in range(POSE_FRAMES)]
        tracker.get_points(frames[0], cam_id=0)
        calls[0] = 0
        per_frame = []
        for f in frames:
            sync(device)
            t0 = time.perf_counter()
            tracker.get_points(f, cam_id=0)
            sync(device)
            per_frame.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(device)
    log(f"markerless (c): OnnxTracker.get_points on {POSE_FRAMES} frames of 1280x720: median {statistics.median(per_frame):.3f} "
        f"ms a frame (min {min(per_frame):.3f}, max {max(per_frame):.3f}), {calls[0] / POSE_FRAMES:.2f} inferences a frame; "
        f"peak device memory {peak / 2**20:.1f} MiB [{smi_line}]")


def blob_detector(in_h, in_w):
    """The JAX suite's hand-weighted SimCC network that localizes three
    pure-color blobs (tests/test_onnx_engine.py:133-155), built with the
    port's GraphBuilder."""
    import numpy as np

    from caliscope_tpu_torch.pose.torch_onnx import GraphBuilder

    b = GraphBuilder("input", (1, 3, in_h, in_w))
    w = np.zeros((3, 3, 1, 1), np.float32)
    for k in range(3):
        w[k, k, 0, 0] = 1.0 / 255.0
    conv = b.node("Conv", ["input", b.init(w, "pick"), b.init(np.full(3, -0.35, np.float32), "bias")],
                  kernel_shape=[1, 1], strides=[1, 1], pads=[0, 0, 0, 0])[0]
    act = b.node("Relu", [conv])[0]
    gain = b.init(np.asarray(90.0, np.float32), "gain")
    mean_x = b.node("ReduceMean", [act, b.init(np.asarray([2], np.int64), "ax_h")], keepdims=0)[0]
    mean_y = b.node("ReduceMean", [act, b.init(np.asarray([3], np.int64), "ax_w")], keepdims=0)[0]
    scales = b.init(np.asarray([1.0, 1.0, 2.0], np.float32), "up2")
    for src, name in ((b.node("Mul", [mean_x, gain])[0], "simcc_x"), (b.node("Mul", [mean_y, gain])[0], "simcc_y")):
        b.node("Resize", [src, "", scales], mode="linear")
        b.graph.nodes[-1].outputs = [name]
    return b.finish(["simcc_x", "simcc_y"])


def render_dots(size, pts_px, radius=7):
    """Dark BGR frame with one solid colored disc per joint
    (tests/test_onnx_engine.py:157-166)."""
    import numpy as np

    colors = np.array([[255, 40, 40], [40, 255, 40], [40, 40, 255]], float)
    W, H = size
    frame = np.full((H, W, 3), 15, np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    for k, (x, y) in enumerate(pts_px):
        frame[(xx - x) ** 2 + (yy - y) ** 2 <= radius**2] = colors[k]
    return frame


def joint_path(n_frames, seed=SEED):
    """(n_frames, 3, 3): a 3-joint 'leg' on a seeded smooth path that fills
    a 1 m cube, turning as it goes (a volume, not a line)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, n_frames)
    freq, phase = rng.uniform(1.0, 2.5, 3), rng.uniform(0, 2 * np.pi, 3)
    root = 0.35 * np.sin(2 * np.pi * freq[None, :] * t[:, None] + phase[None, :]) + np.array([0.0, 0.0, 0.5])
    leg = np.array([[0.0, 0.0, 0.2], [0.05, 0.0, -0.05], [0.1, 0.0, -0.3]])
    c, s = np.cos(2 * np.pi * t), np.sin(2 * np.pi * t)
    z, o = np.zeros_like(c), np.ones_like(c)
    R = np.stack([np.stack([c, -s, z], -1), np.stack([s, c, z], -1), np.stack([z, z, o], -1)], 1)
    return root[:, None, :] + np.einsum("fij,kj->fki", R, leg)


def blob_chain(device):
    """(d): rendered frames -> OnnxTracker (the blob detector) -> ImagePoints
    -> markerless calibrate_extrinsics -> reconstruct_xyz to a TRC file.
    Returns the Schur kernel's launches."""
    import tempfile

    import numpy as np

    from caliscope_tpu_torch.observations import ImagePoints, WorldPoints
    from caliscope_tpu_torch.ops.similarity import umeyama
    from caliscope_tpu_torch.pipelines import calibrate_extrinsics
    from caliscope_tpu_torch.pose.model_card import ModelCard
    from caliscope_tpu_torch.pose.onnx_proto import save_model
    from caliscope_tpu_torch.pose.onnx_tracker import OnnxTracker
    from caliscope_tpu_torch.reconstruction import reconstruct_xyz
    from caliscope_tpu_torch.solvers import fused_schur as FS
    from caliscope_tpu_torch.synthetic.camera_synthesizer import CameraSynthesizer, LensProfile, strip_extrinsics

    lens = LensProfile(size=(640, 480), focal=520.0, distortions=(-0.05, 0.01, 0.0, 0.0, 0.0))
    cameras = CameraSynthesizer(lens).add_ring(CHAIN_CAMERAS, radius=2.2, height=0.6).build()
    joints = joint_path(CHAIN_FRAMES)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        save_model(blob_detector(*CHAIN_MODEL_HW), out / "blob3.onnx")
        (out / "blob3.toml").write_text(
            '[model]\nname = "blob3"\nmodel_path = "blob3.onnx"\nformat = "simcc"\n'
            f"input_size = [{CHAIN_MODEL_HW[1]}, {CHAIN_MODEL_HW[0]}]\nconfidence_threshold = 0.3\n\n"
            "[points]\nhead = 0\nhip = 1\nfoot = 2\n"
        )
        tracker = OnnxTracker(ModelCard.from_toml(out / "blob3.toml"), device=device)
        rows, t0 = [], time.perf_counter()
        for s in range(CHAIN_FRAMES):
            for cid, cam in cameras.cameras.items():
                px = np.asarray(cam.project_points(joints[s]))
                pkt = tracker.get_points(render_dots(cam.size, px), cam_id=cid)
                rows += [(s, cid, int(k), *xy) for k, xy in zip(pkt.keypoint_id, pkt.img_loc)]
        track_s = time.perf_counter() - t0
        rows = np.array(rows)
        ip = ImagePoints(rows[:, 0], rows[:, 1], np.zeros(len(rows)), rows[:, 2], rows[:, 3:5])
        rec = PipelineRecorder()
        FS.schur_s_rhs.launches = 0  # counts from here on are the chain's
        t0 = time.perf_counter()
        with rec.patched():
            run = calibrate_extrinsics(ip, strip_extrinsics(cameras), None, device=device)
        calib_s = time.perf_counter() - t0
        launches, solves = FS.schur_s_rhs.launches, schur_solve_count(rec)
        volume = run.capture_volume
        t0 = time.perf_counter()
        reconstruct_xyz(ip, volume.camera_array, tracker, out, device=device)
        recon_s = time.perf_counter() - t0
        world = WorldPoints.from_csv(out / "xyz_BLOB3.csv")
        trc_rows = len((out / "xyz_BLOB3.trc").read_text().splitlines()) - 6
    center = lambda c: -c.rotation.T @ c.translation  # noqa: E731
    ids = sorted(volume.camera_array.posed_cameras)
    sc, R, t = umeyama(np.array([center(volume.camera_array.cameras[c]) for c in ids]),
                       np.array([center(cameras.cameras[c]) for c in ids]))
    aligned = float(sc) * (R.numpy() @ world.xyz.T).T + t.numpy()
    errs = np.linalg.norm(aligned - joints[world.sync_index, world.keypoint_id], axis=1)
    med = float(np.median(errs))
    log(f"markerless (d): {CHAIN_CAMERAS} cameras x {CHAIN_FRAMES} frames of 640x480 through OnnxTracker in {track_s:.2f} s "
        f"({len(ip)} of {CHAIN_CAMERAS * CHAIN_FRAMES * 3} joints found), markerless calibrate_extrinsics {calib_s:.2f} s "
        f"({len(ids)} of {CHAIN_CAMERAS} cameras posed, RMSE {volume.reprojection_report.overall_rmse:.4f} px), reconstruct_xyz "
        f"{recon_s:.2f} s ({len(world)} points, {trc_rows} TRC frames); 3D joint error after a similarity median "
        f"{med * 1e3:.3f} mm; BA solvers {[r['solver'] for r in rec.results]} (the 'auto' policy), schur_s_rhs launches "
        f"{launches}, Schur solves {solves}")
    if len(ids) != CHAIN_CAMERAS or not med < MAX_CHAIN_MEDIAN_M or trc_rows != len(np.unique(world.sync_index)):
        raise AssertionError(f"markerless (d): {len(ids)} cameras posed, median joint error {med:.4f} m, "
                             f"{trc_rows} TRC frames")
    if launches != solves:
        raise AssertionError(f"markerless (d): schur_s_rhs launched {launches} times for {solves} Schur solves")
    return launches


def markerless_phase(device, smi_line, ring, ring_ip):
    """(a)-(d). Returns the Schur kernel's launches on (a) and (d)."""
    t0 = time.perf_counter()
    launches, run, to_truth, ip = markerless_pipeline(device, ring, ring_ip)
    log(f"markerless (a): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    reconstruction_from(device, ring, run.capture_volume, to_truth, ip)
    log(f"markerless (b): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    pose_inference(device, smi_line)
    log(f"markerless (c): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    chain_launches = blob_chain(device)
    log(f"markerless (d): {time.perf_counter() - t0:.2f} s")
    return launches + chain_launches


def geocalib_on_card(device, smi_line):
    """(a): GeoCalib tiny with seeded random weights and randomized BN,
    exported at VERT_HW and run through OnnxTorchSession against the
    module's forward; then, its up head seeded to a constant field, the
    frames path of the vertical estimator on 8 cameras x 6 frames."""
    import tempfile

    import numpy as np
    import torch

    from caliscope_tpu_torch.estimators import vertical as V
    from caliscope_tpu_torch.estimators.geocalib_arch import GeoCalibFields
    from caliscope_tpu_torch.pose.onnx_proto import parse_model, write_model
    from caliscope_tpu_torch.pose.onnx_torch import OnnxTorchSession

    torch.manual_seed(SEED)
    net = randomized_bn(GeoCalibFields("tiny", decoder_width=64).eval()).to(device)
    t0 = time.perf_counter()
    raw = write_model(net.export_onnx_model(VERT_HW))
    sess = OnnxTorchSession(parse_model(raw), device=device)
    build_s = time.perf_counter() - t0
    x = torch.rand(1, 3, *VERT_HW, device=device, generator=torch.Generator(device=device).manual_seed(SEED))
    with torch.no_grad():
        want = net(x)
    got = sess.forward({"input": x})
    errs = {name: float((g - w).abs().max()) for name, g, w in zip(V.FIELD_NAMES, got, want)}
    close = all(torch.allclose(g, w, atol=POSE_ATOL, rtol=POSE_RTOL) for g, w in zip(got, want))
    log(f"vertical (a): GeoCalib tiny ({sum(p.numel() for p in net.parameters())} parameters, {len(raw)} bytes of ONNX, "
        f"{len(sess.graph.nodes)} nodes) at {VERT_HW[0]}x{VERT_HW[1]} exported and parsed in {build_s:.2f} s; "
        f"OnnxTorchSession vs the module's forward: max |diff| {json.dumps(errs)} (atol {POSE_ATOL}, rtol {POSE_RTOL})")
    if not close:
        raise AssertionError("vertical (a): the executor disagrees with the module's forward")
    times = {"executor_b1_ms": time_ms(lambda: sess.forward({"input": x}), reps=10, rounds=5)}
    with torch.no_grad():
        times["module_b1_ms"] = time_ms(lambda: net(x), reps=10, rounds=5)
    log(f"vertical (a): ms a call (CUDA events, median of 5 x 10 warm calls) {json.dumps({k: round(v, 4) for k, v in times.items()})} [{smi_line}]")

    net.seed_constant_up()
    rng = np.random.default_rng(SEED)
    w, h = VERT_FRAME_WH
    frames = {}
    for cid in range(VERT_CAMERAS):
        base = rng.integers(0, 256, (h // 8, w // 8, 3)).astype(np.uint8)
        frames[cid] = [np.ascontiguousarray(np.roll(np.kron(base, np.ones((8, 8, 1), np.uint8)), 24 * i, axis=1))
                       for i in range(VERT_FRAMES)]
    K = np.array([[1400.0, 0, w / 2], [0, 1400.0, h / 2], [0, 0, 1]])
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / V.GEOCALIB_FILENAME).write_bytes(write_model(net.export_onnx_model(VERT_HW)))
        V.estimate_vertical_from_frames({0: frames[0][:1]}, {0: K}, tmp, device=device)  # warm
        sync(device)
        t0 = time.perf_counter()
        est = V.estimate_vertical_from_frames(frames, {cid: K for cid in frames}, tmp, device=device)
        sync(device)
        seconds = time.perf_counter() - t0
        # where a frame's time goes: the field (upload, resize, network, copy
        # back) and the fit, each on the frames of camera 0
        seeded = OnnxTorchSession(parse_model((Path(tmp) / V.GEOCALIB_FILENAME).read_bytes()), device=device)
        part = {"field_ms": [], "fit_ms": []}
        for frame in frames[0]:
            sync(device)
            t0 = time.perf_counter()
            field, _ = V._infer_up_field(seeded, frame)
            t1 = time.perf_counter()
            V.fit_gravity(field, K * np.array([[VERT_HW[1] / w], [VERT_HW[0] / h], [1.0]]), device=device)
            sync(device)
            part["field_ms"].append(1e3 * (t1 - t0))
            part["fit_ms"].append(1e3 * (time.perf_counter() - t1))
    off = {cid: float(np.degrees(np.arccos(np.clip(up[1], -1, 1)))) for cid, up in est.up_by_camera.items()}
    log(f"vertical (a): estimate_vertical_from_frames on {VERT_CAMERAS} cameras x {VERT_FRAMES} frames of {w}x{h}: "
        f"{seconds:.3f} s ({1e3 * seconds / (VERT_CAMERAS * VERT_FRAMES):.2f} ms a frame: resize, network, fit; medians on "
        f"camera 0: field {np.median(part['field_ms']):.2f} ms, fit {np.median(part['fit_ms']):.2f} ms); "
        f"frames used {est.n_frames_by_camera}; up vs +y in degrees {json.dumps({k: round(v, 6) for k, v in off.items()})} "
        f"[{smi_line}]")
    if sorted(est.up_by_camera) != list(range(VERT_CAMERAS)) or not max(off.values()) < MAX_UP_DEG:
        raise AssertionError(f"vertical (a): a camera's up is more than {MAX_UP_DEG} deg from +y")


def _angle_deg(a, b):
    import numpy as np

    return float(np.degrees(np.arccos(np.clip(abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)), -1, 1))))


def gravity_fits(device, smi_line):
    """(b): fit_gravity on analytic up-fields of 8 known gravities and Ks
    at the network's field size, seeded noise and 10 % outlier pixels: the
    card's default (float64) fit against the truth and against the CPU's,
    and float32 and float64 fits timed with their LM iterations."""
    import statistics

    import numpy as np
    import torch

    from caliscope_tpu_torch.estimators.vertical_solver import fit_gravity

    rng = np.random.default_rng(SEED)
    H, W = VERT_HW
    ys, xs = np.mgrid[0:H, 0:W]
    rows = []
    for _ in range(VERT_CAMERAS):
        g = rng.normal([0.0, 1.0, 0.0], [0.25, 0.05, 0.25])
        g /= np.linalg.norm(g)
        f = rng.uniform(350.0, 700.0)
        K = np.array([[f, 0, W / 2 + rng.uniform(-10, 10)], [0, f, H / 2 + rng.uniform(-10, 10)], [0, 0, 1]])
        pnx, pny = (xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1]
        field = np.stack([g[0] - pnx * g[2], g[1] - pny * g[2]], axis=-1)
        field /= np.linalg.norm(field, axis=-1, keepdims=True)
        field += rng.normal(scale=FIT_NOISE, size=field.shape)
        bad = rng.uniform(size=(H, W)) < FIT_OUTLIERS
        field[bad] = rng.normal(size=(int(bad.sum()), 2))
        cpu = fit_gravity(field, K, FIT_STRIDE, device="cpu")
        rec = {"truth_deg": None, "card_vs_cpu_deg": None}
        for dtype in (torch.float32, torch.float64, None):
            fit_gravity(field, K, FIT_STRIDE, device=device, dtype=dtype)  # warm
            sync(device)
            t0 = time.perf_counter()
            fit = fit_gravity(field, K, FIT_STRIDE, device=device, dtype=dtype)
            sync(device)
            name = "default" if dtype is None else str(dtype).split(".")[-1]
            rec[f"{name}_s"], rec[f"{name}_iterations"] = time.perf_counter() - t0, fit.iterations
            if dtype == torch.float32:
                rec["float32_vs_cpu_deg"] = _angle_deg(fit.gravity_cam, cpu.gravity_cam)
            if dtype is None:
                rec["truth_deg"] = _angle_deg(fit.gravity_cam, g)
                rec["card_vs_cpu_deg"] = _angle_deg(fit.gravity_cam, cpu.gravity_cam)
        rec["cpu_iterations"] = cpu.iterations
        rows.append(rec)
    summary = {k: [round(r[k], 6) if isinstance(r[k], float) else r[k] for r in rows] for k in rows[0]}
    med = {k: statistics.median(r[k] for r in rows) for k in ("float32_s", "float64_s", "default_s")}
    log(f"vertical (b): fit_gravity on {VERT_CAMERAS} analytic fields of {H}x{W} (stride {FIT_STRIDE}, noise {FIT_NOISE}, "
        f"{FIT_OUTLIERS:.0%} outlier pixels): {json.dumps(summary)}; median seconds a camera {json.dumps({k: round(v, 5) for k, v in med.items()})} [{smi_line}]")
    if not max(r["truth_deg"] for r in rows) < MAX_FIT_DEG:
        raise AssertionError(f"vertical (b): a fit is more than {MAX_FIT_DEG} deg from its gravity")
    if not max(r["card_vs_cpu_deg"] for r in rows) < CARD_VS_CPU_FIT_DEG:
        raise AssertionError(f"vertical (b): the card's fit is more than {CARD_VS_CPU_FIT_DEG} deg from the CPU's")


def canonical_dense_problem(device, n_points=N_POINTS, n_obs=N_OBS):
    """The canonical BA problem as CaptureVolume.optimize builds it: (problem,
    start cameras, start points, the host rows it was built from)."""
    import numpy as np

    from caliscope_tpu_torch import convert
    from caliscope_tpu_torch.volume import CaptureVolume

    _truth, start, cam_idx, pt_idx, uv, _X = synth_rig(n_points=n_points, n_obs=n_obs)
    cameras = convert.camera_array(start)
    ip = convert.image_points(
        dict(sync_index=pt_idx, cam_id=cam_idx, object_id=np.zeros_like(pt_idx), keypoint_id=np.zeros_like(pt_idx), img_xy=uv)
    )
    volume = CaptureVolume(cameras, ip, ip.triangulate(cameras, device=device), device=device)
    problem, cam9, X0 = volume.ba_problem()
    _mask, ci, oi, xy, views = volume._matched_arrays()
    rows = dict(cam_idx=ci, pt_idx=oi, uv=xy, K=views.K.numpy(), dist=views.dist.numpy(), fisheye=views.fisheye.numpy(),
                n_points=X0.shape[0], cam9=cam9, X0=X0, device=str(device))
    return problem, cam9, X0, rows


def _shard_config():
    from caliscope_tpu_torch.solvers import bundle

    return bundle.BAConfig(max_iter=SHARD_ITERS, ftol=0.0, xtol=0.0, gtol=0.0, solver="schur")


def timed_solve(device, problem, cam9, X0, mesh=None):
    """One fixed-iteration solve: (result, ms per LM iteration, kernel 1
    launches, all-reduces and bytes per iteration on the mesh)."""
    from caliscope_tpu_torch.solvers import bundle
    from caliscope_tpu_torch.solvers import fused_schur as FS

    launches = FS.schur_s_rhs.launches
    reduces, nbytes = (mesh.all_reduces, mesh.bytes_reduced) if mesh is not None else (0, 0)
    sync(device)
    t0 = time.perf_counter()
    res = bundle.lm_solve(problem, cam9, X0, _shard_config(), mesh=mesh)
    sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / res.n_iterations
    comm = (None, None) if mesh is None else (
        (mesh.all_reduces - reduces) / res.n_iterations, (mesh.bytes_reduced - nbytes) / res.n_iterations)
    return res, ms, FS.schur_s_rhs.launches - launches, comm


def sharded_worker(rank: int, port: int, folder: str) -> int:
    """One of the two gloo ranks of (c), started by sharded_phase with
    `--sharded-worker RANK PORT DIR`: solves DIR/problem.npz's problem on
    its half of the points and writes DIR/rank{RANK}.npz."""
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    import caliscope_tpu_torch  # noqa: F401  (sets the TF32-off defaults)
    from caliscope_tpu_torch.parallel import make_obs_mesh
    from caliscope_tpu_torch.solvers import bundle
    from caliscope_tpu_torch.solvers import fused_schur as FS

    d = dict(np.load(Path(folder) / "problem.npz"))
    device = torch.device(str(d["device"]))
    first = {}

    def recorded(*args):  # the blocks of this rank's first Schur assembly
        first.setdefault("args", tuple(a.clone() for a in args))
        return FS.schur_s_rhs(*args)

    bundle.schur_s_rhs = recorded
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=SHARD_WORLD, rank=rank,
                            timeout=timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        problem = bundle.make_dense_problem(d["cam_idx"], d["pt_idx"], d["uv"], d["K"], d["dist"], d["fisheye"],
                                            n_points=int(d["n_points"]), device=device)
        mesh = make_obs_mesh(device)
        timed_solve(device, problem, d["cam9"], d["X0"], mesh)  # warm
        res, ms, launches, (reduces, nbytes) = timed_solve(device, problem, d["cam9"], d["X0"], mesh)
        process_launches = FS.schur_s_rhs.launches
        args = first["args"]  # the kernel on them is a comparison launch, not the path's
        got, want = FS.schur_s_rhs(*args), FS.schur_s_rhs_plain(*args)
        errs = scaled_errors(got, want, args[3])
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        max_abs = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
        np.savez(Path(folder) / f"rank{rank}.npz", cam9=res.cam9, X=res.X.cpu().numpy(), cost=res.cost_final,
                 iters=res.n_iterations, ms=ms, launches=launches, process_launches=process_launches,
                 reduces=reduces, bytes=nbytes, devices=res.n_devices, block_P=args[0].shape[-1],
                 block_errs=np.array([errs[k] for k in ("S", "rhs", "Hpp_inv")]), block_finite=finite,
                 block_max_abs=max_abs)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _poses(cam9):
    """Rotations (C,3,3) and centers -R^T t (C,3) of (C,9) blocks
    (Rodrigues in numpy)."""
    import numpy as np

    Rs, cs = [], []
    for row in cam9:
        th = np.linalg.norm(row[:3])
        k = row[:3] / th if th > 0 else np.zeros(3)
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        Rs.append(R)
        cs.append(-R.T @ row[3:6])
    return np.array(Rs), np.array(cs)


def pose_gaps(cam9, ref):
    """How far a rig (C,9) is from a reference rig: its centers as they are
    (m), and, after the similarity that best maps its centers onto the
    reference's (the gauge a BA without a fixed camera leaves free), the
    largest center distance (m) and rotation angle (rad); the largest
    difference of the intrinsic columns [s, k1, k2], and of all nine
    columns as they are, over their scale."""
    import numpy as np

    R_a, c_a = _poses(cam9)
    R_b, c_b = _poses(ref)
    mu_a, mu_b = c_a.mean(0), c_b.mean(0)
    A, B = c_a - mu_a, c_b - mu_b
    U, S, Vt = np.linalg.svd(B.T @ A / len(A))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / np.mean(np.sum(A**2, 1))
    c_aligned = s * A @ R.T + mu_b
    # the angle between two rotations from ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2)
    chord = max(np.linalg.norm(Ra @ R.T - Rb) for Ra, Rb in zip(R_a, R_b))
    scale = np.maximum(np.abs(ref).max(axis=0), 1e-12)
    return dict(
        center_m=float(np.linalg.norm(c_a - c_b, axis=1).max()),
        cam9_scaled=float((np.abs(cam9 - ref) / scale).max()),
        aligned_center_m=float(np.linalg.norm(c_aligned - c_b, axis=1).max()),
        aligned_rotation_rad=float(2 * np.arcsin(min(chord / (2 * np.sqrt(2)), 1.0))),
        intrinsics_scaled=float((np.abs(cam9[:, 6:] - ref[:, 6:]) / scale[6:]).max()),
    )


def sharded_phase(device, smi_line, n_points=N_POINTS, n_obs=N_OBS):
    """(c): the canonical problem on one placement, a world-size-1 NCCL mesh
    and two gloo ranks sharing the card, a warm and a timed solve each at a
    fixed iteration count. Returns kernel 1's launches (this process's
    solves and both ranks')."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from caliscope_tpu_torch.parallel import make_obs_mesh
    from caliscope_tpu_torch.solvers import fused_schur as FS

    problem, cam9, X0, rows = canonical_dense_problem(device, n_points, n_obs)
    log(f"sharded (c): {problem.n_cameras} cameras x {problem.n_points} bucketed points x "
        f"{int(problem.obs_mask.sum())} observations, {SHARD_ITERS} LM iterations a solve")
    FS.schur_s_rhs.launches = 0  # counts from here on are the sharded path's
    timed_solve(device, problem, cam9, X0)  # warm
    single, single_ms, single_launches, _ = timed_solve(device, problem, cam9, X0)
    backend = "nccl" if device.type == "cuda" else "gloo"  # gloo: a rehearsal on the CPU
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_obs_mesh(device)
        timed_solve(device, problem, cam9, X0, mesh)  # warm
        nccl, nccl_ms, nccl_launches, (nccl_reduces, nccl_bytes) = timed_solve(device, problem, cam9, X0, mesh)
    finally:
        dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(Path(tmp) / "problem.npz", **rows)
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--sharded-worker", str(r), str(port), tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(SHARD_WORLD)]
        errs = []
        for p in procs:
            try:
                errs.append(p.communicate(timeout=SHARD_TIMEOUT_S)[1])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.communicate()
                raise AssertionError("sharded (c): a gloo rank hung")
        for p, err in zip(procs, errs):
            if p.returncode != 0:
                raise AssertionError(f"sharded (c): a gloo rank failed:\n{err[-3000:]}")
        ranks = [dict(np.load(Path(tmp) / f"rank{r}.npz")) for r in range(SHARD_WORLD)]
    # this process's solves and every solve of both ranks (warm-ups included)
    launches = FS.schur_s_rhs.launches + sum(int(r["process_launches"]) for r in ranks)

    runs = {"single": (single.cam9, single.cost_final, single.n_iterations, single_ms, single_launches, None, None),
            f"{backend}_world_1": (nccl.cam9, nccl.cost_final, nccl.n_iterations, nccl_ms, nccl_launches, nccl_reduces, nccl_bytes)}
    for i, r in enumerate(ranks):
        runs[f"gloo_rank{i}"] = (r["cam9"], float(r["cost"]), int(r["iters"]), float(r["ms"]), int(r["launches"]),
                                 float(r["reduces"]), float(r["bytes"]))
    report = {}
    for name, (c9, cost, iters, ms, n_launch, reduces, nbytes) in runs.items():
        report[name] = dict(
            ms_per_lm_iteration=round(ms, 4), iterations=iters, cost=cost, schur_launches=n_launch,
            all_reduces_per_iteration=reduces, bytes_per_iteration=nbytes,
            cost_rel=abs(cost - single.cost_final) / abs(single.cost_final), **pose_gaps(c9, single.cam9),
        )
    for i, r in enumerate(ranks):
        errs = dict(zip(("S", "rhs", "Hpp_inv"), (float(e) for e in r["block_errs"])))
        log(f"sharded (c): gloo rank {i}: kernel schur_s_rhs on its first LM iteration's blocks (C = {N_CAMERAS}, "
            f"P = {int(r['block_P'])}): scaled max |kernel - plain| {errs} (rtol {BLOCK_RTOL}), "
            f"max |diff| {float(r['block_max_abs']):.3e}")
        if int(r["block_P"]) != -(-problem.n_points // SHARD_WORLD) or not bool(r["block_finite"]) or not all(
                e <= BLOCK_RTOL for e in errs.values()):
            raise AssertionError(f"sharded (c): gloo rank {i}: schur_s_rhs disagrees with its plain version on its shard's blocks")
    same_bits = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ("cam9", "X", "cost"))
    log(f"sharded (c): {json.dumps(report)}; the two gloo ranks' cam9, points and cost equal bit for bit: {same_bits} [{smi_line}]")
    for name, rec in report.items():
        if rec["iterations"] != SHARD_ITERS or rec["schur_launches"] != rec["iterations"]:
            raise AssertionError(f"sharded (c): {name} ran {rec['iterations']} iterations and {rec['schur_launches']} Schur launches")
        if not (rec["cost_rel"] <= SHARD_COST_RTOL and rec["aligned_rotation_rad"] <= SHARD_CAM9_RTOL
                and rec["intrinsics_scaled"] <= SHARD_CAM9_RTOL and rec["aligned_center_m"] <= SHARD_CENTER_M
                and rec["cam9_scaled"] <= SHARD_RAW_CAM9_RTOL and rec["center_m"] <= SHARD_RAW_CENTER_M):
            raise AssertionError(f"sharded (c): {name} is not the single placement's solve: {rec}")
    if not same_bits or int(ranks[0]["devices"]) != SHARD_WORLD or nccl.n_devices != 1:
        raise AssertionError("sharded (c): the ranks disagree or the meshes have the wrong size")
    return launches


def vertical_and_sharded_phase(device, smi_line):
    """(a)-(c). Returns kernel 1's launches on (c)."""
    t0 = time.perf_counter()
    geocalib_on_card(device, smi_line)
    log(f"vertical (a): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    gravity_fits(device, smi_line)
    log(f"vertical (b): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches = sharded_phase(device, smi_line)
    log(f"sharded (c): {time.perf_counter() - t0:.2f} s")
    return launches


# ---------------------------------------------------------------------------
# Baked phase: bake_problem=True, the LM iteration as cached CUDA graphs
# ---------------------------------------------------------------------------

BAKE_TIMING_ITERS = 10
BAKE_TIMING_ROUNDS = 3
BAKE_SCALE_RTOL = 1e-5  # cam9 and X entries against their column's scale, baked vs unbaked


class SolveLog:
    """lm_solve, keeping every result, so that a phase can count the Schur
    solves kernel 1 must have launched for."""

    def __init__(self):
        self.results = []

    def __call__(self, *args, **kwargs):
        from caliscope_tpu_torch.solvers import bundle

        res = bundle.lm_solve(*args, **kwargs)
        self.results.append(res)
        return res

    @property
    def schur_solves(self) -> int:
        return sum(r.n_iterations for r in self.results if r.fused_schur)


def _scaled_gap(a, b):
    """Largest |a - b| over the largest |b| of its column."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b).max(axis=0), 1e-12)).max())


def _same_bits(a, b) -> bool:
    import numpy as np
    import torch

    return bool(np.array_equal(a.cam9, b.cam9) and torch.equal(a.X, b.X))


def baked_vs_unbaked(device, solve, problem, cam9, X0, config, what, mesh=None):
    """An unbaked and then a baked solve of `problem` from the same start,
    gated on the same LM iterations, convergence and CG iterations, every
    cam9 and X entry within BAKE_SCALE_RTOL of its column's scale, and
    kernel 1's launches in the baked solve = its Schur solves. Returns
    (unbaked, baked, the runner the baked solve made)."""
    import dataclasses

    from caliscope_tpu_torch.solvers import fused_schur as FS

    want = solve(problem, cam9, X0, config, mesh=mesh)
    before = dict(getattr(problem, "_baked_runners", {}))
    n0 = FS.schur_s_rhs.launches
    sync(device)
    t0 = time.perf_counter()
    got = solve(problem, cam9, X0, dataclasses.replace(config, bake_problem=True), mesh=mesh)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = FS.schur_s_rhs.launches - n0
    new = [r for k, r in problem._baked_runners.items() if before.get(k) is not r]
    runner = new[0] if new else None
    gaps = dict(cam9=_scaled_gap(got.cam9, want.cam9), X=_scaled_gap(got.X.cpu().numpy(), want.X.cpu().numpy()))
    cg = got.cg_iterations
    log(f"baked {what}: {got.n_iterations} LM iterations (unbaked {want.n_iterations}), converged {got.converged}, "
        f"solver {got.solver}, fused kernel {got.fused_schur}, CG iterations mean {sum(cg) / max(len(cg), 1):.1f} "
        f"max {max(cg, default=0)} (the unbaked solve's: {cg == want.cg_iterations}); cost {got.cost_final:.9e} "
        f"(unbaked {want.cost_final:.9e}); scaled gaps {gaps}; bit-equal to unbaked: {_same_bits(got, want)}; "
        f"kernel 1 launches {launches}; {seconds:.3f} s, the capture included "
        f"({1e3 * runner.capture_seconds if runner else 0.0:.1f} ms)")
    if runner is None or (device.type == "cuda" and runner.graphs is None):
        raise AssertionError(f"baked {what}: the solve captured no CUDA graphs")
    if (got.n_iterations, got.converged, got.cg_iterations) != (want.n_iterations, want.converged, want.cg_iterations):
        raise AssertionError(f"baked {what}: LM / CG counts differ from the unbaked solve's")
    if not max(gaps.values()) <= BAKE_SCALE_RTOL:
        raise AssertionError(f"baked {what}: cam9 / X differ from the unbaked solve's by {gaps} of scale")
    if launches != (got.n_iterations if got.fused_schur else 0):
        raise AssertionError(f"baked {what}: kernel 1 launched {launches} times for {got.n_iterations} Schur solves")
    return want, got, runner


def _event_ms(fn):
    """(CUDA-event ms of fn() per LM iteration of the result it returns, the result)."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    res = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / res.n_iterations, res


def baked_timing(device, smi_line, solve, problem, cam9, X0):
    """ms per LM iteration of the canonical problem at a fixed iteration
    count, unbaked and baked in turns (median of BAKE_TIMING_ROUNDS each),
    the capture's ms, the graphs' pool, host reads an iteration, and one
    solve of each under the profiler (device ms, GPU kernels and syncs an
    iteration, device-busy share)."""
    import dataclasses
    import statistics

    from caliscope_tpu_torch.solvers import bundle

    config = bundle.BAConfig(max_iter=BAKE_TIMING_ITERS, ftol=0.0, xtol=0.0, gtol=0.0, solver="schur")
    baked = dataclasses.replace(config, bake_problem=True)
    _want, _got, runner = baked_vs_unbaked(device, solve, problem, cam9, X0, config, "canonical, 10 iterations")
    reads0, solves0 = runner.host_reads, runner.solves
    times = {False: [], True: []}
    for bake in (False, True, True, False) + (False, True) * (BAKE_TIMING_ROUNDS - 2):
        ms, res = _event_ms(lambda: solve(problem, cam9, X0, baked if bake else config))
        if res.n_iterations != BAKE_TIMING_ITERS:
            raise AssertionError(f"baked timing: a fixed-iteration solve stopped after {res.n_iterations}")
        times[bake].append(ms)
    reads = (runner.host_reads - reads0) / (BAKE_TIMING_ITERS * (runner.solves - solves0))
    report = dict(
        ms_per_lm_iteration=dict(unbaked=statistics.median(times[False]), baked=statistics.median(times[True])),
        ms_each=dict(unbaked=[round(t, 4) for t in times[False]], baked=[round(t, 4) for t in times[True]]),
        capture_ms=1e3 * runner.capture_seconds, graph_pool_mib=(runner.pool_bytes() or 0) / 2**20,
        graphs=sorted(map(str, runner.counts)), host_reads_per_iteration=reads,
        kernel1_launches_per_head_replay=runner.counts.get("head", (None,))[0],
    )
    if device.type == "cuda":
        for bake in (False, True):
            dev_s, n_kernels, syncs, wall = device_costs(device, lambda b=bake: solve(problem, cam9, X0, baked if b else config))
            report["profiled_" + ("baked" if bake else "unbaked")] = dict(
                device_ms_per_iteration=1e3 * dev_s / BAKE_TIMING_ITERS,
                gpu_kernels_per_iteration=n_kernels / BAKE_TIMING_ITERS,
                syncs_per_iteration=syncs / BAKE_TIMING_ITERS, device_busy_share=dev_s / wall,
            )
    log(f"baked canonical timing ({problem.n_cameras} cameras x {problem.n_points} bucketed points, "
        f"{BAKE_TIMING_ITERS} LM iterations a solve, unbaked and baked in turns, CUDA events): {json.dumps(report)} "
        f"[{smi_line}]")
    if reads != 1.0:
        raise AssertionError(f"baked timing: {reads} host reads an LM iteration (the 'schur' loop reads one)")


def baked_sharded(device, smi_line, solve, problem, cam9, X0):
    """A world-size-1 NCCL mesh: an unbaked and two baked fixed-iteration
    solves (the all-reduces inside the graphs), bit-equal, the same
    all-reduces a solve; then a gloo world on the card, where a baked solve
    raises ValueError."""
    import dataclasses

    import torch.distributed as dist

    from caliscope_tpu_torch.parallel import make_obs_mesh
    from caliscope_tpu_torch.solvers import bundle

    config = bundle.BAConfig(max_iter=BAKE_TIMING_ITERS, ftol=0.0, xtol=0.0, gtol=0.0, solver="schur")
    baked = dataclasses.replace(config, bake_problem=True)
    backend = "nccl" if device.type == "cuda" else "gloo"  # gloo: a rehearsal on the CPU
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_obs_mesh(device)
        r0 = mesh.all_reduces
        want = solve(problem, cam9, X0, config, mesh=mesh)
        r1 = mesh.all_reduces
        _want, got, runner = baked_vs_unbaked(device, solve, problem, cam9, X0, config, f"{backend} world 1", mesh=mesh)
        r2 = mesh.all_reduces
        again = solve(problem, cam9, X0, baked, mesh=mesh)
        r3 = mesh.all_reduces
        ms_baked, _ = _event_ms(lambda: solve(problem, cam9, X0, baked, mesh=mesh))
        ms_unbaked, _ = _event_ms(lambda: solve(problem, cam9, X0, config, mesh=mesh))
    finally:
        dist.destroy_process_group()
    per_solve = dict(unbaked=r1 - r0, unbaked_and_first_baked=r2 - r1, second_baked=r3 - r2)
    log(f"baked {backend} world 1: all-reduces a solve {per_solve}, a graph's per replay (kernel 1 launches, "
        f"all-reduces, bytes) {dict((str(k), v) for k, v in runner.counts.items())}; bit-equal to unbaked "
        f"{_same_bits(got, want)}, the second baked solve to the first {_same_bits(again, got)}; ms per LM iteration "
        f"baked {ms_baked:.4f}, unbaked {ms_unbaked:.4f} [{smi_line}]")
    if not (per_solve["unbaked"] > 0 and per_solve["unbaked_and_first_baked"] == 2 * per_solve["unbaked"]
            and per_solve["second_baked"] == per_solve["unbaked"]):
        raise AssertionError(f"baked {backend} world 1: all-reduces {per_solve}; a baked solve counts the unbaked one's")
    if not (_same_bits(got, want) and _same_bits(again, got) and got.n_devices == 1):
        raise AssertionError(f"baked {backend} world 1: the baked solves are not the unbaked one bit for bit")
    if device.type == "cuda":
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
        try:
            try:
                solve(problem, cam9, X0, baked, mesh=make_obs_mesh(device))
            except ValueError as e:
                log(f"baked gloo world 1 on the card raises ValueError, as it must: {e}")
            else:
                raise AssertionError("baked gloo on CUDA tensors solved instead of raising ValueError")
        finally:
            dist.destroy_process_group()


def baked_phase(device, smi_line, static_volume):
    """bake_problem=True on the card: the canonical problem (kernel 1 inside
    the head graph) to convergence, a second solve on the cached graphs,
    timed at a fixed iteration count; 'cg' and 'schur_cg' on it; the
    constrained sparse static-marker problem; a world-size-1 NCCL mesh and
    gloo's refusal. Returns kernel 1's launches over the phase's solves."""
    from caliscope_tpu_torch.solvers import bundle
    from caliscope_tpu_torch.solvers import fused_schur as FS

    problem, cam9, X0, _rows = canonical_dense_problem(device)
    solve = SolveLog()
    FS.schur_s_rhs.launches = 0  # counts from here on are the baked phase's
    _want, got, runner = baked_vs_unbaked(device, solve, problem, cam9, X0, bundle.BAConfig(), "canonical, to convergence")
    graphs, cached = runner.graphs, dict(problem._baked_runners)
    n0 = FS.schur_s_rhs.launches
    again = solve(problem, cam9, X0, bundle.BAConfig(bake_problem=True))
    reused = problem._baked_runners == cached and runner.graphs is graphs and runner.solves == 2
    log(f"baked canonical, a second solve: {again.n_iterations} LM iterations, kernel 1 launches "
        f"{FS.schur_s_rhs.launches - n0}, the cached graphs replayed (no capture): {reused}, bit-equal to the first "
        f"{_same_bits(again, got)}")
    kernel_path = got.fused_schur or device.type != "cuda"  # the CPU (a rehearsal) takes the plain version
    if not (kernel_path and reused and _same_bits(again, got)
            and FS.schur_s_rhs.launches - n0 == (again.n_iterations if again.fused_schur else 0)):
        raise AssertionError("baked canonical: the second solve did not replay the cached graphs with kernel 1")
    baked_timing(device, smi_line, solve, problem, cam9, X0)
    for solver in ("cg", "schur_cg"):
        baked_vs_unbaked(device, solve, problem, cam9, X0, bundle.BAConfig(solver=solver), f"canonical, solver {solver}")
    sproblem, scam9, sX0 = static_volume.ba_problem()
    if not (isinstance(sproblem, bundle.BAProblem) and sproblem.n_constraints):
        raise AssertionError("baked: the static-marker problem is not constrained on the sparse row layout")
    _w, sgot, _r = baked_vs_unbaked(device, solve, sproblem, scam9, sX0, bundle.BAConfig(solver="schur"),
                                    "constrained static markers (sparse rows, 'schur' and its CG)")
    if not sgot.cg_iterations:
        raise AssertionError("baked: the constrained static-marker solve ran no CG")
    baked_sharded(device, smi_line, solve, problem, cam9, X0)
    launches = FS.schur_s_rhs.launches
    log(f"baked: kernel 1 launches {launches} for {solve.schur_solves} Schur solves in {len(solve.results)} solves "
        f"[{smi_line}]")
    if launches != solve.schur_solves:
        raise AssertionError(f"baked: kernel 1 launched {launches} times for {solve.schur_solves} Schur solves")
    return launches


# ---------------------------------------------------------------------------
# Workspace phase: a user's project folder of recordings, through the CLI,
# to a calibrated rig and a reconstruction
# ---------------------------------------------------------------------------

# tests/test_workspace_e2e.py:47-146 at full frame width: its 640 x 480 at
# f = 900 px becomes 1280 x 720 at f scaled with the width; the board
# image's 84 px a square likewise.
WS_WH = (1280, 720)
WS_F = 900.0 * WS_WH[0] / 640
WS_CAMERAS = 4
WS_INTRINSIC_FRAMES = 30
WS_STATIONS, WS_PER_STATION = 8, 12
WS_RECORDING_FRAMES = 32
WS_BOARD = (5, 7, 0.09)  # rows, columns, square (m)
WS_SQ_PX = 84 * WS_WH[0] // 640
WS_CENTER = (0.0, 0.0, 0.55)
WS_BLUR_SIGMA = 0.7
WS_FPS = 30.0
WS_SEED = 3
WS_RENDER_WORKERS = 8
# the JAX suite's own bounds (tests/test_workspace_e2e.py:163-204)
WS_MAX_RMSE_PX = 1.0
WS_MAX_FOCAL_REL = 0.03
WS_MIN_OBSERVATIONS = 500
WS_MAX_CENTER_M = 0.02
WS_MAX_SCALE_REL = 0.03
WS_MAX_RECON_MEDIAN_M = 0.01
WS_CLIP_FRAMES = 16


def ws_rot(axis, ang):
    import numpy as np

    axis = np.asarray(axis, float)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def ws_cameras(n=None, wh=None, f=None):
    """{cam_id: (K, R, t)}: a ring of pinhole cameras aimed at the working
    volume, zero distortion (the recipe's _gt_cameras). Arguments left None
    take the WS_ constants."""
    import numpy as np

    n, wh, f = n or WS_CAMERAS, wh or WS_WH, f or WS_F
    center = np.asarray(WS_CENTER)
    cams = {}
    for i in range(n):
        a = 2 * np.pi * i / n
        c = np.array([1.8 * np.cos(a), 1.8 * np.sin(a), 0.7])
        z = (center - c) / np.linalg.norm(center - c)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        K = np.array([[f, 0, wh[0] / 2], [0, f, wh[1] / 2], [0, 0, 1.0]])
        cams[i] = (K, R, -R @ c)
    return cams


def _board_offset(R):
    import numpy as np

    rows, cols, sq = WS_BOARD
    return R @ np.array([cols * sq / 2, rows * sq / 2, 0.0])


def ws_intrinsic_poses(cams, n, seed=WS_SEED):
    """{cam_id: [(R, t) board poses]}: the board waved in front of each
    camera, its printed face toward it (one generator across the cameras,
    drawn in the recipe's order)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for cid, (K, R, t) in cams.items():
        center = -R.T @ t
        fwd = R.T @ np.array([0, 0, 1.0])
        poses = []
        for k in range(n):
            pos = center + fwd * (1.0 + 0.8 * (k % 10) / 10)
            Rb = R.T @ ws_rot(rng.normal(size=3), rng.uniform(0.05, 0.55))
            poses.append((Rb, pos - _board_offset(Rb) + rng.uniform(-0.06, 0.06, 3)))
        out[cid] = poses
    return out


def ws_station_poses(n_stations, n_per):
    """The extrinsic sweep: the board pauses at 8 azimuths with tilt and
    height variation; the same poses for every camera."""
    import numpy as np

    poses = []
    for k in range(n_stations * n_per):
        station, j = k // n_per, k % n_per
        az = 2 * np.pi * station / 8
        poses.append(_sweep_pose(az, j, n_per, station))
    return poses


def _sweep_pose(az, j, n_per, phase):
    import numpy as np

    tilt = 1.25 + 0.15 * np.sin(2 * np.pi * j / n_per)
    pos = np.asarray(WS_CENTER) + np.array(
        [0.05 * np.cos(az + j), 0.05 * np.sin(az + j), 0.12 * np.sin(2 * np.pi * j / n_per + phase)]
    )
    Rb = ws_rot([0, 0, 1], az) @ ws_rot([1, 0, 0], tilt)
    return Rb, pos - _board_offset(Rb)


def ws_recording_poses(n, n_per):
    """The recording: the sweep's board turning once around the vertical,
    continuously, over n frames (each pose is seen by about two cameras)."""
    import numpy as np

    return [_sweep_pose(2 * np.pi * k / n, k, n_per, 0) for k in range(n)]


def ws_board_corners_world(pose):
    """(N, 3) world positions of the board's inner corners, in keypoint order."""
    import numpy as np

    rows, cols, sq = WS_BOARD
    k = np.arange((rows - 1) * (cols - 1))
    local = np.stack([(k % (cols - 1) + 1) * sq, (k // (cols - 1) + 1) * sq, np.zeros(len(k))], axis=1)
    Rb, tb = pose
    return local @ Rb.T + tb


def ws_render(board_img, sq_px, cam, pose, wh):
    """One grey frame of the board at `pose` through `cam`: the exact
    homography warp of the board image (numpy), white where the board is
    behind the camera or shows its back, then the recipe's 3 x 3 blur."""
    import numpy as np

    from caliscope_tpu_torch.targets import render

    rows, cols, sq = WS_BOARD
    K, R, t = cam
    Rb, tb = pose
    corners_m = np.array([[0, 0, 0], [cols * sq, 0, 0], [cols * sq, rows * sq, 0], [0, rows * sq, 0]], float)
    world = corners_m @ Rb.T + tb
    camf = world @ R.T + t
    white = np.full((wh[1], wh[0]), 255, np.uint8)
    if (camf[:, 2] < 0.1).any():
        return white
    normal = Rb @ np.array([0.0, 0.0, -1.0])  # the printed face looks along board -z
    if np.dot(-R.T @ t - world.mean(axis=0), normal) <= 0.05:
        return white
    uv = (camf / camf[:, 2:3]) @ K.T
    margin = sq_px // 2
    src = margin + corners_m[:, :2] / sq * sq_px - 0.5
    H = render.homography_from_points(src, uv[:, :2])
    img = render.warp_perspective(board_img, H, wh).astype(np.float64)
    k = np.exp(-np.array([1.0, 0.0, 1.0]) / (2.0 * WS_BLUR_SIGMA**2))
    k /= k.sum()
    p = np.pad(img, 1, mode="reflect")
    rows_ = k[0] * p[:, :-2] + k[1] * p[:, 1:-1] + k[2] * p[:, 2:]
    out = k[0] * rows_[:-2] + k[1] * rows_[1:-1] + k[2] * rows_[2:]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def ws_board():
    from caliscope_tpu_torch.targets.charuco import Charuco

    rows, cols, sq = WS_BOARD
    return Charuco(rows=rows, columns=cols, square_size_m=sq)


def ws_render_video(task):
    """Render one camera's video and write it as grey QuickTime with the
    port's writer. task = (path, cam, poses, wh, sq_px, fps). Returns each
    frame's CRC-32. Runs in a worker process."""
    import zlib

    from caliscope_tpu_torch.media.quicktime import RawQuickTimeWriter

    path, cam, poses, wh, sq_px, fps = task
    board_img = ws_board().board_image(px_per_square=sq_px, margin_squares=0.5)
    crcs = []
    with RawQuickTimeWriter(path, wh, fps, "gray") as w:
        for pose in poses:
            frame = ws_render(board_img, sq_px, cam, pose, wh)
            w.write(frame)
            crcs.append(zlib.crc32(frame.tobytes()))
    return crcs


def ws_render_workspace(root, cams):
    """Render the project's videos (the WS_ constants' sizes and counts) into
    the folders of workspace `root` (calibration/intrinsic,
    calibration/extrinsic, recordings/rec0), one video a task on
    WS_RENDER_WORKERS spawned processes (1: in this process). Returns
    ({path: [CRC-32 a frame]}, the recording's board poses)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    root = Path(root)
    wh, sq_px, workers = WS_WH, WS_SQ_PX, WS_RENDER_WORKERS
    intrinsic = ws_intrinsic_poses(cams, WS_INTRINSIC_FRAMES)
    stations = ws_station_poses(WS_STATIONS, WS_PER_STATION)
    rec = ws_recording_poses(WS_RECORDING_FRAMES, WS_PER_STATION)
    tasks = []
    for cid, cam in cams.items():
        tasks.append((root / "calibration" / "intrinsic" / f"cam_{cid}.mp4", cam, intrinsic[cid], wh, sq_px, WS_FPS))
        tasks.append((root / "calibration" / "extrinsic" / f"cam_{cid}.mp4", cam, stations, wh, sq_px, WS_FPS))
        tasks.append((root / "recordings" / "rec0" / f"cam_{cid}.mp4", cam, rec, wh, sq_px, WS_FPS))
    tasks.sort(key=lambda task: -len(task[2]))  # the long videos first
    if workers <= 1:
        crcs = [ws_render_video(task) for task in tasks]
    else:
        with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            crcs = list(pool.map(ws_render_video, tasks))
    return {task[0]: c for task, c in zip(tasks, crcs)}, rec


@contextmanager
def _recording_attr(owner, name, record):
    """Route owner.name(...) through a recorder that keeps its result (or,
    for a report printer, its first argument) in `record`."""
    original = getattr(owner, name)

    def wrapper(*args, **kwargs):
        out = original(*args, **kwargs)
        record.append(out if out is not None else args[0])
        return out

    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, original)


@contextmanager
def _max_threads(n):
    """extract_image_points_multicam with its thread pool cut to n threads."""
    from caliscope_tpu_torch import api

    saved, api._MAX_THREADS = api._MAX_THREADS, n
    try:
        yield
    finally:
        api._MAX_THREADS = saved


def _cuda_activity(device, fn):
    """fn() under torch.profiler with CUDA activity only: (its result, wall
    s, device s as the sum of its GPU kernels' durations, GPU kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return out, wall, sum(e.time_range.elapsed_us() for e in kernels) / 1e6, len(kernels)


def workspace_phase(device, smi_line, tmp):
    """Build a workspace of rendered 1280x720 recordings in folder `tmp` and
    drive it through the CLI in process, from the videos to a calibrated rig
    and a reconstruction, on the card. Returns ((ccl, response, windows)
    launches of the CLI steps, the phase's main path; Schur kernel launches
    there; {check: (ccl, response, windows) launches} of the multicam
    1-vs-4-thread check and the streamer, which are not the main path's;
    the project it leaves for the GUI phase: its root, the cameras' truth,
    the recording's board poses, the seconds a step)."""
    import zlib

    import numpy as np
    import torch

    from caliscope_tpu_torch import __main__ as cli
    from caliscope_tpu_torch import reporting
    from caliscope_tpu_torch.api import extract_image_points, extract_image_points_multicam
    from caliscope_tpu_torch.media import FrameSource, read_video_properties
    from caliscope_tpu_torch.media.streamer import FramePacketStreamer
    from caliscope_tpu_torch.media.video import write_gray_video
    from caliscope_tpu_torch.observations import ImagePoints, WorldPoints
    from caliscope_tpu_torch.ops.similarity import umeyama
    from caliscope_tpu_torch.packets import PixelFormat, TrackedFrame
    from caliscope_tpu_torch.repositories import TargetRouting
    from caliscope_tpu_torch.solvers import fused_schur
    from caliscope_tpu_torch.trackers import CharucoTracker
    from caliscope_tpu_torch.workspace import StepStatus, Workspace

    log(f"workspace phase on {smi_line}")
    root = Path(tmp) / "ws"
    seconds, launches_by_step = {}, {}

    def step(name, *argv):
        before = _detect_counts()[0]
        t0 = time.perf_counter()
        rc = cli.main([name, str(root), *argv, "--device", str(device)])
        sync(device)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        launches_by_step[name] = tuple(a - b for a, b in zip(_detect_counts()[0], before))
        if rc != 0:
            raise AssertionError(f"workspace: `{name}` returned {rc}")

    step("init")
    ws = Workspace(root, device=device)
    board = ws_board()
    ws.targets.save_intrinsic_charuco(board)  # as the JAX suite's recipe sets the project's board
    ws.targets.save_routing(TargetRouting(intrinsic="charuco", extrinsic="charuco"))
    cams = ws_cameras()
    t0 = time.perf_counter()
    crcs, rec_poses = ws_render_workspace(root, cams)
    seconds["render and write"] = time.perf_counter() - t0
    on_disk = sum(p.stat().st_size for p in crcs)
    log(f"workspace: {len(crcs)} videos, {sum(len(c) for c in crcs.values())} frames of {WS_WH[0]}x{WS_WH[1]}, "
        f"{on_disk / 1e6:.1f} MB, rendered and written in {seconds['render and write']:.2f} s "
        f"({WS_RENDER_WORKERS} processes)")

    # decode: every frame read back equals the frame written; rates from the page cache
    decode = {cid: [0, 0, 0.0] for cid in cams}
    for path, want in sorted(crcs.items()):
        cid = int(path.stem.split("_")[1])
        props = read_video_properties(path)
        if (props.size, props.fps, props.frame_count) != (WS_WH, WS_FPS, len(want)):
            raise AssertionError(f"workspace: {path} reads as {props}, written {WS_WH} {WS_FPS} fps {len(want)} frames")
        t0 = time.perf_counter()
        with FrameSource(path, cid, pixel_format=PixelFormat.GRAY) as src:
            got = [zlib.crc32(pkt.frame.tobytes()) for pkt in src]
        decode[cid][2] += time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"workspace: {path} decodes to other frames than were written")
        decode[cid][0] += len(got)
        decode[cid][1] += len(got) * WS_WH[0] * WS_WH[1]
    for cid, (n, nbytes, s) in decode.items():
        log(f"  decode cam {cid}: {n} frames, {nbytes / 1e6 / s:.0f} MB/s, {n / s:.0f} frames/s (page cache)")

    step("export-board", str(root / "board.png"), "--px-per-square", "100")
    png = (root / "board.png").read_bytes()
    if not png.startswith(b"\x89PNG\r\n\x1a\n"):
        raise AssertionError("workspace: export-board wrote no PNG")
    step("status")

    # ---- the main path, its launches counted ----------------------------------
    trackers, intrinsic_outputs, runs = [], [], []
    _zero_detect_counts()
    fused_schur.schur_s_rhs.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    with _recording_attr(Workspace, "make_intrinsic_tracker", trackers), \
            _recording_attr(Workspace, "make_extrinsic_tracker", trackers), \
            _recording_attr(reporting, "print_intrinsic_report", intrinsic_outputs), \
            _recording_attr(reporting, "print_extrinsic_report", runs), \
            recorded_detect_kernels({}) as main_inputs:
        step("calibrate-intrinsics", "--frame-step", "1")
        _, wall, busy, n_kernels = _cuda_activity(device, lambda: step("extract"))
        step("calibrate-extrinsics")
        step("reconstruct", "rec0")
        step("status")
    sync(device)
    (n_ccl, n_resp, n_win), resident = _detect_counts()
    schur_launches = fused_schur.schur_s_rhs.launches
    dispatches = sum(t.dispatches for t in trackers)
    peak = torch.cuda.max_memory_allocated(device)
    recorded_mib = sum(a.numel() * a.element_size() for sub in (main_inputs["ccl"], main_inputs["response"], main_inputs["windows"])
                       for k, args in sub.items() if isinstance(k, tuple) for a in args if hasattr(a, "numel")) / 2**20

    # ---- multicam extraction with 1 and 4 threads, and the streamer: gates of
    # their own, their launches counted apart from the main path's ------------
    rec_videos = {cid: root / "recordings" / "rec0" / f"cam_{cid}.mp4" for cid in cams}
    check_launches = {}

    def counted(name, run):
        """run(trackers) with kernels 2-4 recorded; its launches gated against
        its trackers' dispatches and its inputs held to the plain versions."""
        made = []
        _zero_detect_counts()
        t0 = time.perf_counter()
        with recorded_detect_kernels({}) as inputs:
            out = run(made)
        sync(device)
        seconds[name] = time.perf_counter() - t0
        launches, res = _detect_counts()
        n = sum(t.dispatches for t in made)
        if device.type == "cuda" and not (launches == (n, n, 2 * n) and res == n and n > 0):
            raise AssertionError(f"workspace {name}: launches {launches} (resident {res}) for {n} dispatches")
        if device.type == "cuda":
            check_recorded_detect_kernels(inputs, launches, f"workspace {name}")
        check_launches[name] = launches
        return out

    def multicam(made):
        out = {}
        for n in (1, 4):
            made.append(CharucoTracker(board, device=device))
            with _max_threads(n):
                out[n] = extract_image_points_multicam(rec_videos, made[-1], progress=None)
        return out

    def stream(made):
        made.append(CharucoTracker(board, device=device))
        got = []
        streamer = FramePacketStreamer(rec_videos[0], cam_id=0, tracker=made[-1], fps_override=1000.0,
                                       queue_depth=WS_RECORDING_FRAMES + 1)
        q = streamer.subscribe()
        t0 = time.perf_counter()
        streamer.play()
        try:
            while time.perf_counter() - t0 < 120:
                item = q.get(timeout=60)
                if item is None:
                    break
                got.append(item)
        finally:
            streamer.stop()
        return got

    by_threads = counted("multicam 1 and 4 threads", multicam)
    streamed = counted("streamer", stream)

    # ---- gates ---------------------------------------------------------------
    status = ws.get_workflow_status()
    steps = (status.intrinsic_step_status, status.extrinsic_2d_step_status, status.extrinsic_calibration_step_status)
    if steps != (StepStatus.COMPLETE,) * 3:
        raise AssertionError(f"workspace: workflow steps {steps}, not all COMPLETE")
    if len(intrinsic_outputs) != len(cams):
        raise AssertionError(f"workspace: {len(intrinsic_outputs)} intrinsic calibrations for {len(cams)} cameras")
    for out in intrinsic_outputs:
        f_true = cams[out.camera.cam_id][0][0, 0]
        rel = abs(out.camera.matrix[0, 0] - f_true) / f_true
        log(f"  intrinsics cam {out.camera.cam_id}: RMSE {out.report.rmse:.4f} px, fx {out.camera.matrix[0, 0]:.2f} "
            f"(truth {f_true:.1f}, {100 * rel:.3f} %), {out.report.frames_used} frames")
        if not (out.report.rmse < WS_MAX_RMSE_PX and rel < WS_MAX_FOCAL_REL):
            raise AssertionError(f"workspace: camera {out.camera.cam_id}'s intrinsics miss the recipe's bounds")
    points = ImagePoints.from_csv(ws.xy_csv_path("CHARUCO"))
    n_frames_extracted = len(cams) * WS_STATIONS * WS_PER_STATION
    log(f"  extract: {len(points)} observations, {n_frames_extracted / seconds['extract']:.1f} frames/s over "
        f"{len(cams)} cameras, device idle {100 * (1 - busy / wall):.1f} % ({n_kernels} GPU kernels, "
        f"{busy:.3f} s busy of {wall:.3f} s)")
    if len(points) <= WS_MIN_OBSERVATIONS or set(np.unique(points.cam_id).tolist()) != set(cams):
        raise AssertionError(f"workspace: {len(points)} observations from cameras {np.unique(points.cam_id)}")
    volume = runs[-1].capture_volume
    rmse = volume.reprojection_report.overall_rmse
    est = {cid: -c.rotation.T @ c.translation for cid, c in volume.camera_array.posed_cameras.items()}
    ids = sorted(est)
    truth_c = np.array([-cams[c][1].T @ cams[c][2] for c in ids])
    s, R, t = (np.asarray(v, dtype=np.float64) for v in umeyama(np.array([est[c] for c in ids]), truth_c))
    center_err = np.linalg.norm(float(s) * np.array([est[c] for c in ids]) @ R.T + t - truth_c, axis=1)
    reloaded = ws.capture_volume.load(device=device).reprojection_report.overall_rmse
    log(f"  extrinsics: RMSE {rmse:.4f} px (reloaded {reloaded:.6f}), centers within {1000 * center_err.max():.2f} mm "
        f"after a similarity, scale {float(s):.5f}; Schur kernel launches {schur_launches} (constrained: gate closed)")
    if not (ids == sorted(cams) and rmse < WS_MAX_RMSE_PX and center_err.max() < WS_MAX_CENTER_M
            and abs(float(s) - 1.0) < WS_MAX_SCALE_REL and abs(reloaded - rmse) < 1e-6):
        raise AssertionError("workspace: the calibrated rig misses the recipe's bounds")
    if schur_launches != 0:
        raise AssertionError(f"workspace: the Schur kernel launched {schur_launches} times on constrained problems")
    out_dir = root / "recordings" / "rec0" / "CHARUCO"
    if not ((out_dir / "xyz_CHARUCO.csv").exists() and (out_dir / "xyz_CHARUCO.trc").exists()):
        raise AssertionError(f"workspace: reconstruct wrote no xyz CSV / TRC under {out_dir}")
    wp = WorldPoints.from_csv(out_dir / "xyz_CHARUCO.csv")
    aligned = float(s) * wp.xyz @ R.T + t
    truth_x = np.array([ws_board_corners_world(rec_poses[si])[k] for si, k in zip(wp.sync_index, wp.keypoint_id)])
    recon_err = np.linalg.norm(aligned - truth_x, axis=1)
    log(f"  reconstruct: {len(wp)} points over {len(np.unique(wp.sync_index))} frames, median error "
        f"{1000 * np.median(recon_err):.3f} mm (max {1000 * recon_err.max():.3f})")
    if not np.median(recon_err) < WS_MAX_RECON_MEDIAN_M:
        raise AssertionError("workspace: the recording's board corners miss the truth")
    one, four = by_threads[1], by_threads[4]
    for col in ("sync_index", "cam_id", "object_id", "keypoint_id", "img_xy", "obj_loc", "frame_time"):
        if not np.array_equal(getattr(one, col), getattr(four, col), equal_nan=col in ("obj_loc", "frame_time")):
            raise AssertionError(f"workspace: multicam extraction with 1 and 4 threads differs in {col}")
    if ([tf.packet.frame_index for tf in streamed] != list(range(WS_RECORDING_FRAMES))
            or not all(isinstance(tf, TrackedFrame) for tf in streamed)):
        raise AssertionError(f"workspace: the streamer gave {len(streamed)} tracked frames, not one a frame")
    log(f"  streamer: {len(streamed)} tracked frames of cam 0 in {seconds['streamer']:.2f} s, "
        f"{sum(len(tf.points) > 0 for tf in streamed)} with the board")
    log(f"  kernel launches of the CLI steps: labeling {n_ccl} (resident {resident}), response {n_resp}, windows "
        f"{n_win} for {dispatches} device-program dispatches; by step {json.dumps(launches_by_step)}")
    if not (n_ccl == n_resp == resident == dispatches and n_win == 2 * dispatches and dispatches > 0):
        raise AssertionError("workspace: kernel launches do not match the dispatches")
    if device.type == "cuda":
        check_recorded_detect_kernels(main_inputs, (n_ccl, n_resp, n_win), "workspace CLI steps")
    log(f"  launches outside the CLI steps (not the main path's): {json.dumps(check_launches)}")
    log(f"  peak device memory {peak / 2**20:.1f} MiB over the CLI steps, of which {recorded_mib:.1f} MiB the "
        f"recorder's copies of the kernels' inputs")

    # ---- the card against the port's CPU run (not counted) ----------------------
    clip = Path(tmp) / "clip" / "cam_0.mp4"
    seen = sorted(set(points.sync_index[points.cam_id == 0].tolist()))[:WS_CLIP_FRAMES]  # sync = frame here
    with FrameSource(ws.video_path("extrinsic", 0), 0, wanted_indices=set(seen), pixel_format=PixelFormat.GRAY) as src:
        write_gray_video(clip, [pkt.frame for pkt in src], WS_FPS)
    card = extract_image_points(clip, 0, CharucoTracker(board, device=device), progress=None)
    t0 = time.perf_counter()
    cpu = extract_image_points(clip, 0, CharucoTracker(board, device="cpu"), progress=None)
    cpu_s = time.perf_counter() - t0
    same = all(np.array_equal(getattr(card, c), getattr(cpu, c)) for c in ("sync_index", "object_id", "keypoint_id"))
    gap = float(np.abs(card.img_xy - cpu.img_xy).max()) if same and len(card) else float("inf")
    log(f"  card vs CPU on cam 0's first {len(seen)} extrinsic frames with the board: {len(card)} observations, "
        f"max {gap:.2e} px (CPU {cpu_s:.1f} s)")
    if not (same and gap < GPU_VS_CPU_ATOL_PX):
        raise AssertionError("workspace: the card's extraction parts from the CPU's")

    log("  seconds per step " + json.dumps({k: round(v, 3) for k, v in seconds.items()}))
    handoff = dict(root=root, cams=cams, rec_poses=rec_poses, seconds=seconds, extract_frames=n_frames_extracted,
                   idle=1 - busy / wall)
    return (n_ccl, n_resp, n_win), schur_launches, check_launches, handoff


# ---------------------------------------------------------------------------
# Decode: compressed recordings from the container to the tracker
# ---------------------------------------------------------------------------

DECODE_DIR = ROOT / "tests" / "data" / "video"
DECODE_CODECS = ("h264", "mpeg4", "hevc", "jpeg")
DECODE_MAX_GREY = 2  # decoders and colour conversions against each other (tests/test_torch_decode.py)
DECODE_CORNER_PX = 0.05
DECODE_MIN_ROWS = 0.99
DECODE_JPEG_QUALITY = 100
DECODE_GOP = 12
DECODE_WORKERS = 8


def decode_copy_video(task):
    """Write a raw grey workspace video again, compressed: "h264" as the
    port's lossless I_PCM H.264 (limited range, an IDR frame every
    DECODE_GOP), "mjpeg" as its baseline grey MJPEG at DECODE_JPEG_QUALITY.
    task = (source, destination, kind). Returns the bytes written and each
    frame's luma CRC-32 (H.264) or [] (MJPEG). Runs in a worker process."""
    import zlib

    from caliscope_tpu_torch.media.h264_pcm import H264PcmWriter, luma_from_gray
    from caliscope_tpu_torch.media.mjpeg_writer import MjpegWriter
    from caliscope_tpu_torch.media.video import FrameSource, read_video_properties
    from caliscope_tpu_torch.packets import PixelFormat

    src, dst, kind = task
    props = read_video_properties(src)
    crcs = []
    if kind == "h264":
        writer = H264PcmWriter(dst, props.size, props.fps, gop=DECODE_GOP)
    else:
        writer = MjpegWriter(dst, props.size, props.fps, DECODE_JPEG_QUALITY)
    with FrameSource(src, 0, pixel_format=PixelFormat.GRAY) as frames, writer as w:
        for pkt in frames:
            if kind == "h264":
                luma = luma_from_gray(pkt.frame, False)
                crcs.append(zlib.crc32(luma.tobytes()))
                w.write(luma)
            else:
                w.write(pkt.frame)
    return Path(dst).stat().st_size, crcs


def _matched_rows(got, want):
    """The rows of `want` (an ImagePoints) that `got` holds too, by (sync
    index, camera, keypoint): (the share of want's rows that `got` holds
    within DECODE_CORNER_PX, and the 50th, 99th and 100th percentiles of
    the img_xy distance over the rows both hold)."""
    import numpy as np

    def keyed(ip):
        return {(int(s), int(c), int(k)): xy for s, c, k, xy in zip(ip.sync_index, ip.cam_id, ip.keypoint_id, ip.img_xy)}

    g, w = keyed(got), keyed(want)
    gaps = np.array([float(np.abs(g[k] - w[k]).max()) for k in w if k in g])
    if len(gaps) == 0:
        return 0.0, (float("inf"),) * 3
    return float((gaps <= DECODE_CORNER_PX).sum()) / len(w), tuple(float(q) for q in np.percentile(gaps, [50, 99, 100]))


def _corner_gap(tracker, frames, reference):
    """The tracker on `frames` against the tracker on `reference` (the same
    views decoded otherwise): (the share of the reference's corners found
    within DECODE_CORNER_PX, the largest distance among those found in
    both, the reference's corners)."""
    import numpy as np

    got, want = tracker.get_points_batch(np.stack(frames)), tracker.get_points_batch(np.stack(reference))
    close = total = 0
    gap = 0.0
    for g, w in zip(got, want):
        at = {int(k): xy for k, xy in zip(g.keypoint_id, g.img_loc)}
        total += len(w)
        for k, xy in zip(w.keypoint_id, w.img_loc):
            if int(k) in at:
                d = float(np.abs(at[int(k)] - xy).max())
                close += d <= DECODE_CORNER_PX
                gap = max(gap, d)
    return close / max(total, 1), gap, total


def decode_phase(device, smi_line, root, tmp):
    """Compressed video on the card: (a) NVDEC's answer for four codecs;
    (b) the committed clips under tests/data/video/ (MJPEG through nvJPEG
    against the numpy decoder, mp4v through NVDEC against OpenCV's frames or
    raising as the caps say, the tracker on both); (c) the workspace cell's
    extrinsic videos (4 cameras x 96 frames of 1280x720) written again as
    I_PCM H.264 and as MJPEG, decoded and extracted through
    api.extract_image_points_multicam against the raw videos. Returns the
    (ccl, response, windows) launches of (c)'s compressed extraction, the
    phase's main path, and {check: launches} of the runs it is held to."""
    import multiprocessing
    import zlib
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from caliscope_tpu_torch.api import extract_image_points_multicam
    from caliscope_tpu_torch.exceptions import CalibrationError
    from caliscope_tpu_torch.media import FrameSource, nvdec
    from caliscope_tpu_torch.media.nvjpeg import NvJpegDecoder
    from caliscope_tpu_torch.media.quicktime import read_track
    from caliscope_tpu_torch.packets import PixelFormat
    from caliscope_tpu_torch.trackers import CharucoTracker

    log(f"decode phase on {smi_line}")
    board = ws_board()
    checks = {}

    def frames_of(path, fmt=PixelFormat.GRAY, dev=device, wanted=None):
        with FrameSource(path, 0, pixel_format=fmt, device=dev, wanted_indices=wanted) as src:
            return {p.frame_index: p.frame for p in src}

    def refused(path, codec, run=None):
        """The card's NVDEC refuses `codec`: opening `path`, and `run` when
        given, must raise CalibrationError carrying the caps' answer."""
        for call in (lambda: FrameSource(path, 0, device=device), run):
            if call is None:
                continue
            try:
                call()
            except CalibrationError as e:
                if f"refuses {codec}" not in str(e) or caps[codec].get("error", "supported") not in str(e):
                    raise AssertionError(f"decode: {path.name} raised without the caps' answer: {e}") from e
                log(f"  {path.name}: raises as the caps say: {str(e)[:200]}")
            else:
                raise AssertionError(f"decode: the caps refuse {codec} but {path.name} decoded")

    # (a) ---------------------------------------------------------------------
    caps = {c: nvdec.decoder_caps(c, device) for c in DECODE_CODECS}
    for c, answer in caps.items():
        log(f"  NVDEC {c} at 8-bit 4:2:0: {json.dumps(answer)} ({smi_line})")

    # (b) ---------------------------------------------------------------------
    t0 = time.perf_counter()
    mj = DECODE_DIR / "board_mjpeg.mov"
    backend = NvJpegDecoder(device).backend
    worst = {}
    for fmt in (PixelFormat.GRAY, PixelFormat.BGR):
        card, cpu = frames_of(mj, fmt), frames_of(mj, fmt, dev="cpu")
        if sorted(card) != sorted(cpu) or not card:
            raise AssertionError(f"decode: {mj.name} gives frames {sorted(card)} on the card, {sorted(cpu)} on the CPU")
        worst[fmt.name] = max(int(np.abs(card[i].astype(int) - cpu[i]).max()) for i in card)
    log(f"  {mj.name}: nvJPEG ({backend}) against the numpy decoder, {len(card)} frames of 1280x720: largest "
        f"difference {worst['GRAY']} grey levels, {worst['BGR']} in BGR ({smi_line})")
    if worst["GRAY"] > DECODE_MAX_GREY:
        raise AssertionError(f"decode: nvJPEG differs from the numpy decoder by {worst['GRAY']} grey levels")
    tracker = CharucoTracker(board, device=device)
    _zero_detect_counts()
    card, cpu = frames_of(mj), frames_of(mj, dev="cpu")
    share, gap, n = _corner_gap(tracker, [card[i] for i in sorted(card)], [cpu[i] for i in sorted(cpu)])
    log(f"  {mj.name}: the tracker on the card's frames against its corners on the numpy decoder's: {100 * share:.1f} % "
        f"of {n} corners found within {DECODE_CORNER_PX} px, the largest distance {gap:.2e} px")
    if not (n > 0 and share >= DECODE_MIN_ROWS):
        raise AssertionError("decode: the tracker's corners on nvJPEG's frames miss the numpy decoder's")
    m4 = DECODE_DIR / "board_mp4v.mp4"
    ref = np.load(DECODE_DIR / "board_mp4v_cv2_gray.npz")
    if caps["mpeg4"]["supported"]:
        card = frames_of(m4)
        worst_m4 = max(int(np.abs(card[int(i)].astype(int) - f).max()) for i, f in zip(ref["index"], ref["frames"]))
        sparse = frames_of(m4, wanted={1, 13, 15})
        log(f"  {m4.name}: NVDEC against OpenCV's frames at {ref['index'].tolist()}: largest difference {worst_m4} "
            f"grey levels; frames 1, 13, 15 alone (sync samples {np.flatnonzero(read_track(m4).sync).tolist()}) "
            f"{'equal' if all(np.array_equal(sparse[i], card[i]) for i in sparse) else 'DIFFERENT'}")
        if worst_m4 > DECODE_MAX_GREY or sorted(sparse) != [1, 13, 15] or not all(np.array_equal(sparse[i], card[i]) for i in sparse):
            raise AssertionError("decode: NVDEC's mp4v frames miss OpenCV's")
        share, gap, n = _corner_gap(tracker, [card[int(i)] for i in ref["index"]], list(ref["frames"]))
        log(f"  {m4.name}: the tracker on NVDEC's frames against OpenCV's: {100 * share:.1f} % of {n} corners within "
            f"{DECODE_CORNER_PX} px, the largest distance {gap:.2e} px")
        if not (n > 0 and share >= DECODE_MIN_ROWS):
            raise AssertionError("decode: the tracker's corners on NVDEC's mp4v frames miss OpenCV's")
    else:
        refused(m4, "mpeg4")
    checks["committed clips"] = _detect_counts()[0]
    log(f"  committed clips: {time.perf_counter() - t0:.2f} s")

    # (c) ---------------------------------------------------------------------
    cams = range(WS_CAMERAS)
    raw = {cid: Path(root) / "calibration" / "extrinsic" / f"cam_{cid}.mp4" for cid in cams}
    out = Path(tmp) / "decode"
    copies = {kind: {cid: out / kind / f"cam_{cid}.mp4" for cid in cams} for kind in ("h264", "mjpeg")}
    tasks = [(raw[cid], copies[kind][cid], kind) for kind in copies for cid in cams]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=DECODE_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        written = dict(zip([(t[2], int(t[1].stem.split("_")[1])) for t in tasks], pool.map(decode_copy_video, tasks)))
    n_frames = sum(len(written[("h264", cid)][1]) for cid in cams)
    log(f"  the workspace cell's {len(cams)} x {n_frames // len(cams)} extrinsic frames written again in "
        f"{time.perf_counter() - t0:.2f} s ({DECODE_WORKERS} processes): H.264 "
        f"{sum(written[('h264', c)][0] for c in cams) / 1e6:.1f} MB, MJPEG "
        f"{sum(written[('mjpeg', c)][0] for c in cams) / 1e6:.1f} MB (raw {sum(p.stat().st_size for p in raw.values()) / 1e6:.1f} MB)")

    def extract(videos):
        tracker = CharucoTracker(board, device=device)
        t0 = time.perf_counter()
        ip = extract_image_points_multicam(videos, tracker, progress=None)
        sync(device)
        return ip, time.perf_counter() - t0, tracker

    _zero_detect_counts()
    ip_raw, raw_s, _ = extract(raw)
    checks["raw extraction"] = _detect_counts()[0]
    log(f"  raw extraction: {len(ip_raw)} observations, {n_frames / raw_s:.1f} frames/s ({smi_line})")

    if caps["h264"]["supported"]:
        for cid in cams:
            t = read_track(copies["h264"][cid])
            dec = nvdec.NvdecDecoder("h264", t.extradata, (t.width, t.height), device, nal_length_size=t.nal_length_size)
            got = {}
            with open(copies["h264"][cid], "rb") as f:
                for d in range(t.frame_count):
                    f.seek(int(t.offsets[d]))
                    dec.feed(f.read(int(t.sizes[d])), int(t.display[d]))
                    got.update((i, zlib.crc32(y.cpu().numpy().tobytes())) for i, (y, _) in dec.frames.items())
                    dec.frames.clear()
                dec.end()
                got.update((i, zlib.crc32(y.cpu().numpy().tobytes())) for i, (y, _) in dec.frames.items())
            dec.close()
            if [got.get(i) for i in range(t.frame_count)] != written[("h264", cid)][1]:
                raise AssertionError(f"decode: NVDEC's luma of camera {cid}'s H.264 differs from the luma written")
        log(f"  H.264: every luma plane NVDEC gave back equals the luma written, bit for bit ({n_frames} frames)")
    else:
        refused(copies["h264"][0], "h264",
                lambda: extract_image_points_multicam(copies["h264"], CharucoTracker(board, device=device), progress=None))

    # the main path: the compressed copies through decode and extraction
    decoded = {}
    for kind in ("mjpeg", "h264") if caps["h264"]["supported"] else ("mjpeg",):
        for cid in cams:
            nbytes = written[(kind, cid)][0]
            sync(device)
            t0 = time.perf_counter()
            with FrameSource(copies[kind][cid], cid, pixel_format=PixelFormat.GRAY, device=device) as src:
                opened = time.perf_counter() - t0
                t0 = time.perf_counter()
                frames = {p.frame_index: p.frame for p in src}
                s = time.perf_counter() - t0
            if kind == "mjpeg":
                want = frames_of(raw[cid], dev=None)
                worst_c = max(int(np.abs(frames[i].astype(int) - want[i]).max()) for i in want)
                if worst_c > DECODE_MAX_GREY:
                    raise AssertionError(f"decode: camera {cid}'s MJPEG (quality {DECODE_JPEG_QUALITY}) is {worst_c} levels off")
            decoded[(kind, cid)] = (len(frames), s, nbytes)
            log(f"  decode {kind} cam {cid}: opened in {1000 * opened:.1f} ms, then {len(frames)} frames, "
                f"{len(frames) / s:.1f} frames/s, {len(frames) * WS_WH[0] * WS_WH[1] / 1e6 / s:.1f} MB/s of frames, "
                f"{nbytes / 1e6 / s:.1f} MB/s of bitstream ({smi_line})")
    results = {}
    _zero_detect_counts()
    torch.cuda.reset_peak_memory_stats(device)
    trackers = []
    with recorded_detect_kernels({}) as inputs:
        for kind in [k for k in ("mjpeg", "h264") if (k, 0) in decoded]:
            (ip, _, tr), wall, busy, n_kernels = _cuda_activity(device, lambda: extract(copies[kind]))
            trackers.append(tr)
            results[kind] = (ip, wall, busy, n_kernels)
    sync(device)
    launches, resident = _detect_counts()
    peak = torch.cuda.max_memory_allocated(device)
    dispatches = sum(t.dispatches for t in trackers)
    for kind, (ip, wall, busy, n_kernels) in results.items():
        share, (p50, p99, gap) = _matched_rows(ip, ip_raw)
        log(f"  extraction on {kind}: {len(ip)} observations against the raw run's {len(ip_raw)}: {100 * share:.2f} % "
            f"of its rows within {DECODE_CORNER_PX} px (distance median {p50:.2e}, 99th percentile {p99:.2e}, largest "
            f"{gap:.2e} px); {n_frames / wall:.1f} frames/s over {len(cams)} cameras, device idle "
            f"{100 * (1 - busy / wall):.1f} % ({n_kernels} GPU kernels, {busy:.3f} s busy of {wall:.3f} s) ({smi_line})")
        if not share >= DECODE_MIN_ROWS:
            raise AssertionError(f"decode: extraction on the {kind} copies misses the raw run's observations")
    log(f"  kernel launches of the compressed extraction: {launches} (resident {resident}) for {dispatches} dispatches; "
        f"peak device memory {peak / 2**20:.1f} MiB; nvJPEG decodes {NvJpegDecoder.launches}, NVDEC pictures "
        f"{nvdec.NvdecDecoder.launches} in this process")
    if not (launches == (dispatches, dispatches, 2 * dispatches) and resident == dispatches and dispatches > 0):
        raise AssertionError("decode: kernel launches do not match the dispatches")
    check_recorded_detect_kernels(inputs, launches, "decode extraction")
    return launches, checks


# ---------------------------------------------------------------------------
# GUI: the workspace phase's recordings through the port's main window
# ---------------------------------------------------------------------------

GUI_ACTION_TIMEOUT_S = 300.0
GUI_UNDISTORT_MAX_GREY = 1  # grid_sample on the card against the CPU (CameraData.undistort_frame)


def _pump(app, until, what, timeout=GUI_ACTION_TIMEOUT_S):
    """Process the GUI's queued events until until() holds."""
    deadline = time.monotonic() + timeout
    while True:
        app.processEvents()
        if until():
            return
        if time.monotonic() > deadline:
            raise AssertionError(f"gui: {what} did not finish within {timeout:.0f} s")
        time.sleep(0.005)


def _largest_difference(a: bytes, b: bytes):
    """Max |x - y| over the numbers two text files hold in the same places
    (None when their words differ otherwise or in count)."""
    import re

    num = re.compile(rb"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|nan|inf")
    ta, tb = num.split(a), num.split(b)
    na, nb = num.findall(a), num.findall(b)
    if ta != tb or len(na) != len(nb):
        return None
    return max((abs(float(x) - float(y)) for x, y in zip(na, nb) if x != y), default=0.0)


def _same_files(cli_root, gui_root, rels):
    """Each file under rels (files, or folders taken whole) in both roots,
    compared byte for byte, each root's own path read as the same word (a
    TRC header names the file's path). Returns {relative path: bytes};
    raises on the first file that differs or is missing, with its largest
    difference."""
    compared = {}
    for rel in rels:
        a, b = cli_root / rel, gui_root / rel
        names = sorted(p.relative_to(cli_root) for p in a.rglob("*") if p.is_file()) if a.is_dir() else [Path(rel)]
        gui_names = sorted(p.relative_to(gui_root) for p in b.rglob("*") if p.is_file()) if b.is_dir() else [Path(rel)]
        if names != gui_names or not names:
            raise AssertionError(f"gui: {rel} holds {[str(n) for n in gui_names]}, the CLI's {[str(n) for n in names]}")
        for name in names:
            want = (cli_root / name).read_bytes().replace(str(cli_root).encode(), b"<project>")
            got = (gui_root / name).read_bytes().replace(str(gui_root).encode(), b"<project>")
            if got != want:
                raise AssertionError(f"gui: {name} differs from the CLI's (largest numeric difference "
                                     f"{_largest_difference(got, want)})")
            compared[str(name)] = len(got)
    return compared


def gui_phase(device, smi_line, handoff):
    """The workspace phase's recordings, copied into a fresh project folder,
    through the port's GUI on the headless Qt backend, driven as a user
    clicks it (module docstring, phase 11). Returns ((ccl, response,
    windows) launches, Schur kernel launches) of the GUI run, its main
    path."""
    os.environ["CALISCOPE_TPU_FORCE_HEADLESS_QT"] = "1"
    import shutil
    from collections import Counter

    import numpy as np
    import torch

    from caliscope_tpu_torch import api
    from caliscope_tpu_torch.cameras import CameraArray, CameraData
    from caliscope_tpu_torch.gui import qt
    from caliscope_tpu_torch.gui.main_window import MainWindow
    from caliscope_tpu_torch.gui.tab_names import TabName
    from caliscope_tpu_torch.observations import ImagePoints, WorldPoints
    from caliscope_tpu_torch.ops.similarity import umeyama
    from caliscope_tpu_torch.presenters.processing import ProcessingState
    from caliscope_tpu_torch.solvers import fused_schur as FS
    from caliscope_tpu_torch.workspace import StepStatus, Workspace

    if qt.USING_PYSIDE6:
        raise AssertionError("gui: CALISCOPE_TPU_FORCE_HEADLESS_QT is set and PySide6 was loaded")
    log(f"gui phase on {smi_line}")
    cli_root, cams, rec_poses = handoff["root"], handoff["cams"], handoff["rec_poses"]
    root = cli_root.parent / "gui_ws"
    t0 = time.perf_counter()
    for sub in ("calibration/intrinsic", "calibration/extrinsic", "recordings/rec0"):
        (root / sub).mkdir(parents=True)
        for video in sorted((cli_root / sub).glob("cam_*.mp4")):
            shutil.copyfile(video, root / sub / video.name)
    log(f"gui: recordings copied into a fresh project folder in {time.perf_counter() - t0:.2f} s")
    cli_cams = CameraArray.from_toml(cli_root / "camera_array.toml")  # the undistortion preview's cameras
    app = qt.QApplication.instance() or qt.QApplication([])
    seconds = {}

    def act(name, click, done):
        t0 = time.perf_counter()
        click()
        _pump(app, done, name)
        sync(device)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    # the Cameras tab's extraction spans (start, end) a camera, and each
    # undistortion preview call, with the first of each camera held to the CPU
    spans, undistorted, grey_gap = {}, Counter(), {}
    extract, undistort = api.extract_image_points, CameraData.undistort_frame

    def timed_extract(video_path, cam_id, *args, **kwargs):
        t0 = time.perf_counter()
        out = extract(video_path, cam_id, *args, **kwargs)
        sync(device)
        spans[cam_id] = (t0, time.perf_counter())
        return out

    def counted_undistort(cam, frame, device=None):
        out = undistort(cam, frame, device=device)
        if cam.cam_id not in grey_gap:
            cpu = undistort(cam, frame, device="cpu")
            grey_gap[cam.cam_id] = int(np.abs(out.astype(np.int16) - cpu.astype(np.int16)).max())
        undistorted[cam.cam_id] += 1
        return out

    trackers, pipeline = [], PipelineRecorder()
    _zero_detect_counts()
    FS.schur_s_rhs.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    api.extract_image_points, CameraData.undistort_frame = timed_extract, counted_undistort
    win = None
    try:
        with _recording_attr(Workspace, "make_intrinsic_tracker", trackers), \
                _recording_attr(Workspace, "make_extrinsic_tracker", trackers), \
                pipeline.patched(), recorded_detect_kernels({}) as inputs:
            t0 = time.perf_counter()
            win = MainWindow(workspace_dir=root, settings_path=root / "app_settings.toml", device=device)
            seconds["open project"] = time.perf_counter() - t0
            ws = win.ws

            # 1. Project tab: the board and the routing, as the CLI recipe sets them
            t0 = time.perf_counter()
            board = ws_board()
            project = win.project_tab
            panel = project.intrinsic_charuco_panel
            panel.rows.setValue(board.rows)
            panel.columns.setValue(board.columns)
            panel.square_mm.setValue(board.square_size_m * 1000.0)
            panel.apply_btn.click()
            project.intrinsic_type.setCurrentText("charuco")
            project.extrinsic_type.setCurrentText("charuco")
            project.same_as_intrinsic.setChecked(True)
            got_board = ws.targets.load_extrinsic_charuco()
            if (got_board.rows, got_board.columns, got_board.square_size_m) != (board.rows, board.columns, board.square_size_m):
                raise AssertionError(f"gui: the Project tab saved {got_board}, not the recipe's {board}")
            seconds["project targets"] = time.perf_counter() - t0

            # 2. Cameras tab: each camera's Calibrate, the display thread live
            cameras_tab = win.cameras_tab
            cameras_tab.frame_skip_spin.setValue(1)  # the CLI step's --frame-step 1 (the tab's default is 5)
            shown, dropped = {}, {}
            _, cam_wall, cam_busy, cam_kernels = _cuda_activity(device, lambda: [
                _gui_calibrate_camera(app, act, cameras_tab, cid, cli_cams.cameras[cid], shown, dropped)
                for cid in sorted(cams)
            ])
            # 3. Extract tab
            if not win.tabs.isTabEnabled(win.tab_index(TabName.EXTRACT)):
                raise AssertionError("gui: the Extract tab is disabled after every camera's intrinsics")
            extract_tab = win.extract_tab
            _, ext_wall, ext_busy, ext_kernels = _cuda_activity(device, lambda: act(
                "extract", extract_tab.extract_btn.click, extract_tab.extract_btn.isEnabled))
            if "observations" not in extract_tab.status.text():
                raise AssertionError(f"gui: extraction failed: {extract_tab.status.text()}")
            # 4. Extrinsics tab
            if not win.tabs.isTabEnabled(win.tab_index(TabName.EXTRINSICS)):
                raise AssertionError("gui: the Extrinsics tab is disabled after the extraction")
            xt = win.extrinsic_tab
            n_solves0 = len(pipeline.solves)
            act("calibrate extrinsics", xt.calib_btn.click, xt.calib_btn.isEnabled)
            if not xt.summary.text().startswith("RMSE"):
                raise AssertionError(f"gui: extrinsic calibration failed: {xt.summary.text()}")
            schur_extrinsics = FS.schur_s_rhs.launches
            extrinsic_solves = pipeline.solves[n_solves0:]
            # 5. Reconstruct tab
            if not win.tabs.isTabEnabled(win.tab_index(TabName.RECONSTRUCT)):
                raise AssertionError("gui: the Reconstruct tab is disabled after the extrinsic calibration")
            rv = win.reconstruct_tab
            rv.rec_box.setCurrentText("rec0")
            if rv.selected_tracker_key() is not None:
                raise AssertionError(f"gui: the Reconstruct tab's tracker is {rv.tracker_box.currentText()}, not the target's")
            act("reconstruct", rv.run_btn.click, lambda: rv.state in (ProcessingState.COMPLETE, ProcessingState.FAILED))
            if rv.state != ProcessingState.COMPLETE:
                raise AssertionError(f"gui: reconstruction failed: {rv.status.text()}")
            # 6. Explorer tab, its default preset
            ex = win.explorer_tab
            n_solves0, n_results0 = len(pipeline.solves), len(pipeline.results)
            act("explorer", ex.run_btn.click, ex.run_btn.isEnabled)
            if not ex.status.text().startswith("RMSE"):
                raise AssertionError(f"gui: the Explorer's pipeline failed: {ex.status.text()}")
            project.refresh()
            strip = {name: project.step_strip.step_state(name) for name in project.step_strip.STEPS}
            sync(device)
    except BaseException:
        if win is not None:
            win.close()  # stops the workspace watcher and the render threads
        raise
    finally:
        api.extract_image_points, CameraData.undistort_frame = extract, undistort
    (n_ccl, n_resp, n_win), resident = _detect_counts()
    schur_launches = FS.schur_s_rhs.launches
    dispatches = sum(t.dispatches for t in trackers)
    peak = torch.cuda.max_memory_allocated(device)

    # ---- gates: the workspace phase's, on the GUI's own files ------------------------
    status = ws.get_workflow_status()
    steps = (status.intrinsic_step_status, status.extrinsic_2d_step_status, status.extrinsic_calibration_step_status)
    if steps != (StepStatus.COMPLETE,) * 3 or set(strip.values()) != {"●"}:
        raise AssertionError(f"gui: workflow steps {steps}, step strip {strip}")
    saved = ws.cameras.load()
    for cid in sorted(cams):
        report = ws.intrinsic_reports.load(cid)
        f_true, fx = cams[cid][0][0, 0], shown[cid]["fx"]
        rel = abs(fx - f_true) / f_true
        log(f"  gui intrinsics cam {cid}: RMSE {report.rmse:.4f} px, fx {fx:.2f} (truth {f_true:.1f}, "
            f"{100 * rel:.3f} %), {report.frames_used} frames; {shown[cid]['displayed']} frames displayed "
            f"({undistorted[cid]} undistorted, {grey_gap.get(cid)} grey levels from the CPU's), {dropped[cid]} dropped")
        if not (report.rmse < WS_MAX_RMSE_PX and rel < WS_MAX_FOCAL_REL):
            raise AssertionError(f"gui: camera {cid}'s intrinsics miss the recipe's bounds")
        if shown[cid]["displayed"] < 1 or undistorted[cid] < 1 or grey_gap[cid] > GUI_UNDISTORT_MAX_GREY:
            raise AssertionError(f"gui: camera {cid}'s live display: {shown[cid]}, undistorted {undistorted[cid]}, "
                                 f"{grey_gap.get(cid)} grey levels from the CPU's")
    points = ImagePoints.from_csv(ws.xy_csv_path("CHARUCO"))
    if len(points) <= WS_MIN_OBSERVATIONS or set(np.unique(points.cam_id).tolist()) != set(cams):
        raise AssertionError(f"gui: {len(points)} observations from cameras {np.unique(points.cam_id)}")
    volume = xt.presenter.capture_volume
    rmse = volume.reprojection_report.overall_rmse
    est = {cid: -c.rotation.T @ c.translation for cid, c in saved.posed_cameras.items()}
    ids = sorted(est)
    truth_c = np.array([-cams[c][1].T @ cams[c][2] for c in ids])
    s, R, t = (np.asarray(v, dtype=np.float64) for v in umeyama(np.array([est[c] for c in ids]), truth_c))
    center_err = np.linalg.norm(float(s) * np.array([est[c] for c in ids]) @ R.T + t - truth_c, axis=1)
    log(f"  gui extrinsics: RMSE {rmse:.4f} px, centers within {1000 * center_err.max():.2f} mm after a similarity, "
        f"scale {float(s):.5f}; {len(points)} observations")
    if not (ids == sorted(cams) and rmse < WS_MAX_RMSE_PX and center_err.max() < WS_MAX_CENTER_M
            and abs(float(s) - 1.0) < WS_MAX_SCALE_REL):
        raise AssertionError("gui: the calibrated rig misses the recipe's bounds")
    wp = WorldPoints.from_csv(root / "recordings" / "rec0" / "CHARUCO" / "xyz_CHARUCO.csv")
    truth_x = np.array([ws_board_corners_world(rec_poses[si])[k] for si, k in zip(wp.sync_index, wp.keypoint_id)])
    recon_err = np.linalg.norm(float(s) * wp.xyz @ R.T + t - truth_x, axis=1)
    log(f"  gui reconstruct: {len(wp)} points, median error {1000 * np.median(recon_err):.3f} mm; "
        f"{rv.stats.text()}")
    if not np.median(recon_err) < WS_MAX_RECON_MEDIAN_M:
        raise AssertionError("gui: the recording's board corners miss the truth")

    # ---- the GUI's files are the CLI's ----------------------------------------------
    compared = _same_files(cli_root, root, [
        "camera_array.toml", "intrinsic/reports", ws.xy_csv_path("CHARUCO").relative_to(root), "capture_volume",
        "recordings/rec0/CHARUCO",
    ])
    log(f"  gui files equal to the CLI's byte for byte: {len(compared)} files, {sum(compared.values())} bytes: "
        + ", ".join(sorted(compared)))

    # ---- images the user sees -----------------------------------------------------------
    panel0 = cameras_tab._panels[min(cams)]
    for name, label in (("playback", xt.playback.canvas), ("coverage heatmap", panel0.heatmap.canvas),
                        ("lens model", panel0.lens.canvas), ("live view", panel0.video_label),
                        ("reconstruction preview", rv.preview.canvas if rv.preview is not None else None)):
        img = label.pixmap().image.array if label is not None and label.pixmap() is not None else None
        if img is None or img.size == 0 or not (img != img.reshape(-1, img.shape[-1])[0]).any():
            raise AssertionError(f"gui: the {name} image is empty or flat")

    # ---- kernels ---------------------------------------------------------------------------
    log(f"  gui kernel launches: labeling {n_ccl} (resident {resident}), response {n_resp}, windows {n_win} for "
        f"{dispatches} device-program dispatches")
    if not (n_ccl == n_resp == resident == dispatches and n_win == 2 * dispatches and dispatches > 0):
        raise AssertionError("gui: kernel launches do not match the dispatches")
    if device.type == "cuda":
        check_recorded_detect_kernels(inputs, (n_ccl, n_resp, n_win), "gui")
    explorer_solves = pipeline.results[n_results0:]
    if not explorer_solves or len(explorer_solves) != len(pipeline.solves) - n_solves0:
        raise AssertionError(f"gui: {len(explorer_solves)} lm_solve calls for {len(pipeline.solves) - n_solves0} BA stages")
    schur_solves = sum(s["iterations"] for s, r in zip(pipeline.solves[n_solves0:], explorer_solves) if r["solver"] == "schur")
    log(f"  gui Schur kernel: {schur_extrinsics} launches on the Extrinsics tab ({len(extrinsic_solves)} constrained "
        f"BA stages: gate closed), {schur_launches - schur_extrinsics} on the Explorer = its Schur solves "
        f"{schur_solves} (solvers {[r['solver'] for r in explorer_solves]}, 'auto' on a preset of "
        f"{explorer_solves[0]['n_points']} points)")
    if schur_extrinsics != 0 or schur_launches - schur_extrinsics != schur_solves:
        raise AssertionError("gui: Schur kernel launches do not match the Schur solves")
    if device.type == "cuda":  # the kernel takes float32 blocks
        errs, Pb = first_iteration_block_errors(device, pipeline.boot)
        log(f"  gui: kernel schur_s_rhs on the Explorer bootstrap's first LM iteration (P = {Pb}): scaled max "
            f"|kernel - plain| {errs} (rtol {BLOCK_RTOL}; a comparison launch, not counted)")
        if not all(e <= BLOCK_RTOL for e in errs.values()):
            raise AssertionError(f"gui: schur_s_rhs disagrees with its plain version on the Explorer's blocks: {errs}")

    # ---- rates ------------------------------------------------------------------------------
    cli_s = handoff["seconds"]
    n_intr = WS_INTRINSIC_FRAMES * len(cams)
    intr_extract_s = sum(b - a for a, b in spans.values())
    log(f"  gui Cameras tab: intrinsic extraction {n_intr / intr_extract_s:.1f} frames/s with the display thread on "
        f"({intr_extract_s:.2f} s for {n_intr} frames; the CLI's calibrate-intrinsics took {cli_s['calibrate-intrinsics']:.2f} s "
        f"in all, the tab {sum(seconds[f'calibrate cam {c}'] for c in cams):.2f} s), device idle "
        f"{100 * (1 - cam_busy / cam_wall):.1f} % ({cam_kernels} GPU kernels) [{smi_line}]")
    log(f"  gui Extract tab: {handoff['extract_frames'] / seconds['extract']:.1f} frames/s against the CLI's "
        f"{handoff['extract_frames'] / cli_s['extract']:.1f}; device idle {100 * (1 - ext_busy / ext_wall):.1f} % "
        f"against the CLI's {100 * handoff['idle']:.1f} % ({ext_kernels} GPU kernels) [{smi_line}]")
    log(f"  gui frames displayed {sum(v['displayed'] for v in shown.values())}, dropped {sum(dropped.values())}; "
        f"peak device memory {peak / 2**20:.1f} MiB [{smi_line}]")
    log("  gui seconds per action " + json.dumps({k: round(v, 3) for k, v in seconds.items()}) + f" [{smi_line}]")
    win.close()
    return (n_ccl, n_resp, n_win), schur_launches


def _gui_calibrate_camera(app, act, cameras_tab, cid, calibrated, shown, dropped):
    """Select camera cid in the Cameras tab and click its Calibrate, with the
    undistortion preview on (through `calibrated`, the CLI run's camera);
    pump until the panel reports. Fills shown[cid] (fx, frames displayed)
    and dropped[cid]."""
    cameras_tab.camera_list.select_cam_id(cid)
    panel = cameras_tab._panels[cid]
    started = {}

    def click():
        panel.run_btn.click()
        if panel.presenter is None or panel.render_thread is None:
            raise AssertionError(f"gui: camera {cid}'s Calibrate did not start: {panel.status_label.text()}")
        started["presenter"], started["thread"] = panel.presenter, panel.render_thread
        panel.render_thread.set_undistort(True, calibrated)

    act(f"calibrate cam {cid}", click, lambda: panel.presenter is None)
    rt = started["thread"]
    if rt.isRunning() or rt.error is not None:
        raise AssertionError(f"gui: camera {cid}'s render thread: running {rt.isRunning()}, error {rt.error!r}")
    presenter = started["presenter"]
    if presenter.output is None or panel.status_label.text().startswith("Error") or panel.render_error is not None:
        raise AssertionError(f"gui: camera {cid}'s calibration failed: {panel.status_label.text()}")
    shown[cid] = dict(fx=float(presenter.output.camera.matrix[0, 0]), displayed=rt.frames_rendered)
    dropped[cid] = presenter.display_queue.dropped


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "caliscope_tpu_torch").is_dir():
        print(f"chip_smoke: the caliscope_tpu_torch package is not beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import caliscope_tpu_torch  # noqa: F401  (sets the TF32-off defaults)
    from caliscope_tpu_torch import _cuda_build

    started = time.perf_counter()
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} device {kind}")
    log(smi_line)
    if kind not in PEAKS:
        raise RuntimeError(f"chip_smoke: no published peak rates for {kind!r}; add them to PEAKS to compute bounds")
    peaks = PEAKS[kind]
    log(f"peaks used for bounds: {peaks[0] / 1e12:.2f} TB/s, {peaks[1] / 1e12:.1f} TFLOP/s FP32 (non-tensor, FMA = 2), "
        f"{peaks[2] / 1e12:.1f} T FP32 instructions/s")

    t0 = time.perf_counter()
    _cuda_build.build_all()
    log(f"built {len(_cuda_build.KERNELS)} kernels and {len(_cuda_build.SOURCES) - len(_cuda_build.KERNELS)} library shim "
        f"(nvJPEG) in {time.perf_counter() - t0:.2f} s, one nvcc process each, started together")
    for name in _cuda_build.SOURCES:
        built = _cuda_build.build_logs[name] or _cuda_build.build_seconds[name]
        log(f"  {name}.cu: " + (f"{_cuda_build.build_seconds[name]:.2f} s" if built else "found already built, reused"))
        for line in _cuda_build.build_logs[name].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log("    ptxas: " + line.strip())

    entry = kernel_phase(device, peaks)
    ch, frames, truths = detect_frames()
    detect_entries = detect_kernel_phase(device, peaks, frames)
    t0 = time.perf_counter()
    detect_launches, dispatches = detect_slice_phase(device, ch, frames, truths, smi_line)
    log(f"detection slice: {time.perf_counter() - t0:.2f} s in all")
    for e, n in zip(detect_entries, detect_launches):
        e["launches"] = n

    t0 = time.perf_counter()
    launches, schur_solves, records, filtered = slice_phase(device)
    log(f"slice: {time.perf_counter() - t0:.2f} s; schur_s_rhs launches {launches}, Schur solves {schur_solves}")
    if launches < 1 or launches != schur_solves:
        raise AssertionError(f"schur_s_rhs launched {launches} times for {schur_solves} Schur solves")
    entry["launches"] = launches
    kernel_it, plain_it, Pb = lm_iteration_times(device, filtered)
    log(
        f"LM iteration at {N_CAMERAS} cameras x {Pb} bucketed points: {kernel_it:.3f} ms with the kernel, "
        f"{plain_it:.3f} ms without (best of 2 runs of 10 iterations each)"
    )
    prof = profile_lm_iterations(device, filtered)
    log("profile (per LM iteration) " + (json.dumps(prof) if prof else "not measured (the profiler recorded no device time)"))
    t0 = time.perf_counter()
    pipe_launches, pipe_stages, ring, ring_ip = pipeline_phase(device, smi_line)
    log(f"pipeline phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    constrained_launches, static_volume = constrained_phase(device, smi_line, pipe_stages, ring, ring_ip, filtered)
    log(f"constrained and sparse pipelines phase: {time.perf_counter() - t0:.2f} s")
    entry["launches"] = launches + pipe_launches + constrained_launches
    entry["launches_by_path"] = {
        "ba_slice": launches, "pipeline": pipe_launches, "constrained_and_sparse_pipelines": constrained_launches,
        "intrinsics_from_frames": 0, "chessboard": 0, "aruco": 0, "markerless": 0,
    }
    t0 = time.perf_counter()
    intr_launches, tracker_shapes = intrinsic_phase(device, peaks)
    log(f"intrinsic phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    markerless_launches = markerless_phase(device, smi_line, ring, ring_ip)
    log(f"markerless phase: {time.perf_counter() - t0:.2f} s")
    entry["launches"] += markerless_launches
    entry["launches_by_path"]["markerless"] = markerless_launches
    t0 = time.perf_counter()
    sharded_launches = vertical_and_sharded_phase(device, smi_line)
    log(f"vertical and sharded phase: {time.perf_counter() - t0:.2f} s")
    entry["launches"] += sharded_launches
    entry["launches_by_path"]["sharded"] = sharded_launches
    t0 = time.perf_counter()
    baked_launches = baked_phase(device, smi_line, static_volume)
    del static_volume
    log(f"baked phase: {time.perf_counter() - t0:.2f} s")
    entry["launches"] += baked_launches
    entry["launches_by_path"]["baked"] = baked_launches
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ws_") as tmp:
        t0 = time.perf_counter()
        ws_launches, ws_schur, ws_checks, handoff = workspace_phase(device, smi_line, tmp)
        log(f"workspace phase: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        gui_launches, gui_schur = gui_phase(device, smi_line, handoff)
        log(f"gui phase: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        decode_launches, decode_checks = decode_phase(device, smi_line, handoff["root"], tmp)
        log(f"decode phase: {time.perf_counter() - t0:.2f} s")
    entry["launches"] += ws_schur + gui_schur
    entry["launches_by_path"]["workspace"] = ws_schur
    entry["launches_by_path"]["gui"] = gui_schur
    entry["launches_by_path"]["decode"] = 0
    for i, e in enumerate(detect_entries):
        e["launches_by_path"] = ({"detection_slice": e["launches"]} | {path: n[i] for path, n in intr_launches.items()}
                                 | {"markerless": 0, "sharded": 0, "baked": 0, "workspace": ws_launches[i], "gui": gui_launches[i],
                                    "decode": decode_launches[i]})
        e["launches"] = sum(e["launches_by_path"].values())
        e["launches_outside_main_paths"] = ({f"workspace {check}": n[i] for check, n in ws_checks.items()}
                                            | {f"decode {check}": n[i] for check, n in decode_checks.items()})
        e["tracker_shapes"] = tracker_shapes[e["name"]]
    # kernel 4's TMA-path launches: those of the main paths' runs (the
    # detection slice's count, the others' recorders), and the checks'
    main_runs = ("detection slice", "intrinsics (b)", "chessboard", "aruco", "workspace CLI steps", "gui", "decode extraction")
    win_entry = detect_entries[2]
    win_entry["tma_launches_by_path"] = {run: TMA_LAUNCHES_BY_RUN[run] for run in main_runs}
    win_entry["tma_launches"] = sum(win_entry["tma_launches_by_path"].values())
    win_entry["tma_launches_outside_main_paths"] = {run: n for run, n in TMA_LAUNCHES_BY_RUN.items() if run not in main_runs}
    if not 0 < win_entry["tma_launches"] <= win_entry["launches"]:
        raise AssertionError(f"extract_windows: {win_entry['tma_launches']} TMA-path launches of {win_entry['launches']}")
    log(f"kernel extract_windows: {win_entry['tma_launches']} of its {win_entry['launches']} main-path launches on the TMA path "
        f"{json.dumps(win_entry['tma_launches_by_path'])}")
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all, the kernels' build included")
    log(json.dumps({"kernels": [entry, *detect_entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--sharded-worker":
        sys.exit(sharded_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
