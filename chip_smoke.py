#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (caliscope_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and the
repository checkout beside this file; it exits non-zero without them and
on any failed check. Phases:

1. Versions, and the card's name and power limit as nvidia-smi reports them.
2. Build every kernel of the port from the checkout's sources (nvcc, at
   first use, into caliscope_tpu_torch/_build/).
3. Kernel phase: each kernel against its plain PyTorch version on the card,
   at the main path's shapes (and a ragged one), with its times (CUDA
   events, median of warm repetitions), a one-call PyTorch yardstick and
   the least time the card could take for the same work.
4. Slice phase: the canonical real-session bundle-adjustment problem
   (8 cameras, 35,000 points, 141,422 observations, 0.5 px noise; the
   recipe of bench.py, perturbed initial translations) through
   CaptureVolume on the card — linear BA, robust BA with intrinsics, 2.5 %
   percentile filter, final BA — with the kernels' launch counts, the
   kernel-less Schur path's final cost, and the recovered rig against the
   truth.
5. A `kernels` JSON line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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

# Published peaks (bytes/s, non-tensor FP32 operations/s) of the card the
# bounds are computed for, keyed by torch.cuda.get_device_name(): the H100
# SXM's data-sheet rates at its full 700 W power limit.
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}


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

    from caliscope_tpu_torch.solvers import fused_schur as FS

    def inputs(C, P, seed):
        rng = np.random.default_rng(seed)
        Jc = rng.normal(size=(C, 2, 9, P)).astype(np.float32) * 0.1
        Jp = rng.normal(size=(C, 2, 3, P)).astype(np.float32) * 0.1
        w = rng.uniform(0.5, 1.0, size=(C, 2, P)).astype(np.float32)
        bp = rng.normal(size=(3, P)).astype(np.float32)
        w[:, :, 7] = 0.0  # one unobserved point: the pinned branch
        Jp[:, :, :, 7] = 0.0
        t = [torch.from_numpy(a).to(device) for a in (Jc, Jp, w, bp)]
        return t + [torch.tensor([LAM], dtype=torch.float32, device=device)]

    results = {}
    # the main path's shape (C = 8, P = bucket_size(35001, fine=True)), a
    # ragged point count, and the camera bound
    for C, P in ((N_CAMERAS, 40_960), (N_CAMERAS, 12_345), (FS.MAX_CAMERAS, 4_099)):
        args = inputs(C, P, seed=C * 100_000 + P)
        got = FS.schur_s_rhs(*args)
        want = FS.schur_s_rhs_plain(*args)
        torch.cuda.synchronize()
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
        log(f"kernel schur_s_rhs C={C} P={P}: matches plain (max |diff| {err:.3e}, rtol=atol={KERNEL_RTOL})")
        results[(C, P)] = (args, err)

    args, err = results[(N_CAMERAS, 40_960)]
    C, P = N_CAMERAS, 40_960
    n_cp = 9 * C
    launches_before = FS.schur_s_rhs.launches
    ms = time_ms(lambda: FS.schur_s_rhs(*args))
    plain_ms = time_ms(lambda: FS.schur_s_rhs_plain(*args))
    FS.schur_s_rhs.launches = launches_before  # timing launches are not the main path's
    # yardstick: the (72, 3P) x (3P, 72) product that carries most of the
    # FLOPs, one torch.matmul (no single PyTorch call computes the function)
    A = torch.randn(n_cp, 3 * P, device=device)
    B = torch.randn(3 * P, n_cp, device=device)
    library_ms = time_ms(lambda: torch.matmul(A, B))
    bytes_, flops = schur_work(C, P)
    mem_rate, f32_rate = peaks
    t_bytes, t_ops = bytes_ / mem_rate * 1e3, flops / f32_rate * 1e3
    entry = {
        "name": "schur_s_rhs",
        "route": "cuda",
        "source": "caliscope_tpu_torch/csrc/schur_s_rhs.cu",
        "replaces": "caliscope_tpu/solvers/pallas_schur.py:132",
        "launches": None,  # filled from the slice phase
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    log(
        f"kernel schur_s_rhs C={C} P={P}: {ms:.4f} ms (plain {plain_ms:.4f} ms, one (72,3P)x(3P,72) "
        f"torch.matmul {library_ms:.4f} ms); needs {bytes_ / 1e6:.1f} MB and {flops / 1e9:.3f} GFLOP -> "
        f"bound {entry['bound_ms'] * 1e3:.1f} us by {entry['bound_by']}"
    )
    return entry


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
    errs = first_iteration_block_errors(device, volume)
    log(f"kernel schur_s_rhs on the first LM iteration's blocks: scaled max |kernel - plain| {errs} (rtol {BLOCK_RTOL})")
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


def dense_problem(device, volume):
    """The dense LM problem CaptureVolume.optimize builds for `volume`
    (same bucketing), with its start cameras and points."""
    import numpy as np

    from caliscope_tpu_torch.ops.bucket import bucket_size
    from caliscope_tpu_torch.solvers import bundle

    _m, cam_idx, obj_idx, uv, views = volume._matched_arrays()
    Pb = bucket_size(len(volume.world_points) + 1, fine=True)
    X0 = np.tile(volume.world_points.xyz.mean(0), (Pb, 1))
    X0[: len(volume.world_points)] = volume.world_points.xyz
    problem = bundle.make_dense_problem(
        cam_idx, obj_idx, uv, views.K.numpy(), views.dist.numpy(), views.fisheye.numpy(), n_points=Pb,
        device=device,
    )
    return problem, bundle.initial_cam9(volume.camera_array), X0


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
    points, the start damping): scaled errors as `scaled_errors` gives
    them. Its launch is not the main path's."""
    import torch

    from caliscope_tpu_torch.solvers import bundle
    from caliscope_tpu_torch.solvers import fused_schur as FS

    problem, cam9, X0 = dense_problem(device, volume)
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
            raise AssertionError(f"schur_s_rhs: non-finite {name} on the canonical problem's blocks")
    return scaled_errors(got, want, bp_t)


def lm_iteration_times(device, volume, iters=10):
    """Best ms per LM iteration of the filtered canonical problem at a fixed
    iteration count, with and without the kernel, run in turns (plain,
    kernel, kernel, plain)."""
    from caliscope_tpu_torch.solvers import bundle

    problem, cam9, X0 = dense_problem(device, volume)
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


def profile_lm_iterations(device, volume, iters=3):
    """torch.profiler over a fixed-iteration kernel-path solve of the
    filtered canonical problem: wall ms per iteration (with the profiler's
    own overhead), device-busy share (sum of GPU kernel times over wall
    time; one stream, so kernels do not overlap), GPU kernels launched per
    iteration, and the top kernels and the top operators (with their input
    shapes) by device time. Returns None when the profiler records no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from caliscope_tpu_torch.solvers import bundle

    problem, cam9, X0 = dense_problem(device, volume)
    config = bundle.BAConfig(max_iter=iters, ftol=0.0, xtol=0.0, gtol=0.0, solver="schur")
    bundle.lm_solve(problem, cam9, X0, config)  # warm
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        bundle.lm_solve(problem, cam9, X0, config)
        sync(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ops = sorted(
        (e for e in prof.key_averages(group_by_input_shape=True) if e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )[:6]
    return {
        "wall_ms_per_iteration": wall_us / 1e3 / iters,
        "device_busy_share": busy_us / wall_us,
        "device_ms_per_iteration": busy_us / 1e3 / iters,
        "gpu_kernels_per_iteration": len(kernels) / iters,
        "top_kernels_device_ms_per_iteration": {name[:60]: us / 1e3 / iters for name, us in top},
        "top_ops_device_ms_per_iteration": {
            f"{e.key} {e.input_shapes}"[:100]: e.self_device_time_total / 1e3 / iters for e in ops
        },
    }


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
    from caliscope_tpu_torch.solvers import fused_schur as FS

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
    log(f"peaks used for bounds: {peaks[0] / 1e12:.2f} TB/s, {peaks[1] / 1e12:.1f} TFLOP/s FP32 (non-tensor)")

    t0 = time.perf_counter()
    FS.build_library()
    log(f"built {FS.SOURCE.name} in {time.perf_counter() - t0:.2f} s")
    for line in FS.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    entry = kernel_phase(device, peaks)
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
    log("profile " + (json.dumps(prof) if prof else "not measured (the profiler recorded no device time)"))
    log(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
