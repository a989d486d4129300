"""The port's sharded bundle adjustment (caliscope_tpu_torch/parallel/,
the mesh path of solvers/bundle.py) on two CPU processes joined over gloo,
the cases of tests/test_sharded_bundle.py:

- one sparse `lm_iteration`, a full sparse solve (the problem sharded
  first), the `shard` policy inside lm_solve, the dense layout's solve,
  reprojection-only and with constraint rows, and CaptureVolume.optimize
  sharded;
- each held against the port's own single placement (the same LM iteration
  count, the cost within rtol 1e-10) and against the JAX package's
  lm_solve over its mesh of 8 virtual CPU devices (tests/conftest.py), in
  float64: the cost within rtol 1e-12 and the cameras within 1e-11 (1e-9
  on the constrained solve, whose CG's roundoff grows over up to 200
  iterations; seen: 1.1e-13 and 2.4e-11);
- both ranks' results equal bit for bit;
- the collectives of the dense solve: one all-reduce of a fixed-size
  fingerprint that checks the ranks hold the same problem, per LM
  iteration six all-reduces of fixed, point-free sizes (g_c and d_c,
  gnorm's maximum, kernel 1's S and rhs, the cost, the predicted decrease,
  the norms), one more for the first cost, and one all-gather of the
  points after the loop: no point-axis tensor is gathered while it runs;
- ranks that hold different problems (other values, other shapes) all
  raise ValueError, and stay in step for the cases after.

The two ranks (tests/torch_sharded_worker.py) start once for the file, from
a module fixture, and run while this process computes the JAX references.
"""

from __future__ import annotations

import socket
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from caliscope_tpu.parallel import make_obs_mesh as jax_mesh
from caliscope_tpu.parallel import shard_problem as jax_shard
from caliscope_tpu.parallel import sharded_lm_iteration as jax_sharded_iteration
from caliscope_tpu.solvers import bundle as JB

from caliscope_tpu_torch.ops.bucket import bucket_size
from caliscope_tpu_torch.parallel.sharded import CHECKED_FIELDS
from caliscope_tpu_torch.solvers import bundle as TB
from caliscope_tpu_torch.synthetic.camera_synthesizer import strip_extrinsics
from caliscope_tpu_torch.synthetic.factories import default_ring_scene
from caliscope_tpu_torch.volume import CaptureVolume

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
COST_RTOL = 1e-12
CAM_ATOL = 1e-11
CG_CAM_ATOL = 1e-9  # the constrained solve's CG: roundoff grows over its iterations
SELF_RTOL = 1e-10  # sharded against the port's single placement


def inputs():
    """The JAX test's problem (default_ring_scene(8 frames), start cameras
    perturbed with seed 5), built with the port on the CPU, as numpy arrays;
    its dense layout bucketed; six constraint rows between real points."""
    scene = default_ring_scene(noise_sigma_px=0.5, n_frames=8)
    ip = scene.image_points_noisy()
    views = scene.cameras.device_views(posed_only=True, device="cpu")
    id_to_idx = {int(c): i for i, c in enumerate(views.cam_ids)}
    cam_idx = np.array([id_to_idx[int(c)] for c in ip.cam_id])
    pt_idx, keys = ip.point_index()
    wp = ip.triangulate(scene.cameras, device="cpu")
    key_map = {tuple(k): i for i, k in enumerate(wp.keys())}
    X0 = wp.xyz[np.array([key_map[tuple(k)] for k in keys])]
    cam9 = TB.initial_cam9(scene.cameras)
    rng = np.random.default_rng(5)
    cam9[:, 3:6] += rng.normal(scale=0.02, size=(len(cam9), 3))
    Pb = bucket_size(X0.shape[0] + 1, fine=True)
    Xb = np.concatenate([X0, np.tile(X0.mean(axis=0), (Pb - X0.shape[0], 1))])
    rng = np.random.default_rng(11)
    pa, pb = rng.integers(0, 40, size=(6, 1)), rng.integers(0, 40, size=(6, 1))
    w4 = np.pad(np.ones((6, 1)), ((0, 0), (0, 3)))
    return dict(
        cam_idx=cam_idx, pt_idx=pt_idx, uv=ip.img_xy, K=views.K.numpy(), dist=views.dist.numpy(),
        fisheye=views.fisheye.numpy(), cam9=cam9, X0=X0, n_points=Pb, Xb=Xb,
        pa_idx=np.pad(pa, ((0, 0), (0, 3))), pa_w=w4, pb_idx=np.pad(pb, ((0, 0), (0, 3))), pb_w=w4,
        target=np.linalg.norm(Xb[pa[:, 0]] - Xb[pb[:, 0]], axis=1), weight=np.full(6, 50.0),
    )


def jax_references(d):
    """The JAX package's solves of every case over its 8-device mesh."""
    mesh = jax_mesh()
    jp = JB.make_problem(d["cam_idx"], d["pt_idx"], d["uv"], d["K"], d["dist"], d["fisheye"])
    out = {}
    lam = np.asarray(1e-4)
    out["iteration"] = [np.asarray(v) for v in jax_sharded_iteration(jax_shard(jp, mesh), d["cam9"], d["X0"], lam, mesh, cg_max_iter=100)]
    out["sparse"] = JB.lm_solve(jax_shard(jp, mesh), d["cam9"], d["X0"], JB.BAConfig(max_iter=20, solver="cg"))
    out["policy"] = JB.lm_solve(jp, d["cam9"], d["X0"], JB.BAConfig(max_iter=15, shard="always"))
    dense = JB.make_dense_problem(d["cam_idx"], d["pt_idx"], d["uv"], d["K"], d["dist"], d["fisheye"], n_points=int(d["n_points"]))
    fixed = dict(ftol=0.0, gtol=0.0, xtol=0.0, solver="schur")
    out["dense"] = JB.lm_solve(dense, d["cam9"], d["Xb"], JB.BAConfig(max_iter=10, **fixed), mesh=mesh)
    constrained = replace(
        dense, con_pa_idx=d["pa_idx"].astype(np.int32), con_pa_w=d["pa_w"], con_pb_idx=d["pb_idx"].astype(np.int32),
        con_pb_w=d["pb_w"], con_target=d["target"], con_weight=d["weight"],
    )
    out["constrained"] = JB.lm_solve(constrained, d["cam9"], d["Xb"], JB.BAConfig(max_iter=6, **fixed), mesh=mesh)
    # CaptureVolume.optimize's solve: the port's bootstrapped volume's
    # problem, as optimize() builds it, through the JAX package's lm_solve
    scene = default_ring_scene(noise_sigma_px=0.5, n_frames=8)
    vol = CaptureVolume.bootstrap(scene.image_points_noisy(), strip_extrinsics(scene.cameras), device="cpu")
    _mask, cam_idx, obj_idx, uv, views = vol._matched_arrays()
    problem, cam9_0, X0 = vol.ba_problem()
    vp = JB.make_dense_problem(cam_idx, obj_idx, uv, views.K.numpy(), views.dist.numpy(), views.fisheye.numpy(), n_points=X0.shape[0])
    out["volume"] = JB.lm_solve(vp, cam9_0, X0, JB.BAConfig(max_iter=200, ftol=1e-8), mesh=mesh)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results, rank 1's results, the JAX references)."""
    tmp = tmp_path_factory.mktemp("sharded")
    d = inputs()
    np.savez(tmp / "inputs.npz", **d)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_sharded_worker.py"), str(r), str(WORLD), str(port),
             str(tmp / "inputs.npz"), str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(tmp),
        )
        for r in range(WORLD)
    ]
    try:
        refs = jax_references(d)
    finally:
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=240))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("a sharded worker hung")
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks[0], ranks[1], refs


def test_the_ranks_agree_bit_for_bit(runs):
    r0, r1, _ = runs
    assert sorted(r0) == sorted(r1)
    for key in r0:
        assert np.array_equal(r0[key], r1[key]), key


def test_sparse_iteration(runs):
    r, _, refs = runs
    for i, name in enumerate(("cam9", "X", "lam", "cost", "accept")):
        single, sharded = r[f"iteration_single_{name}"], r[f"iteration_sharded_{name}"]
        np.testing.assert_allclose(sharded, single, rtol=SELF_RTOL, atol=1e-13)
        np.testing.assert_allclose(sharded, refs["iteration"][i], rtol=COST_RTOL, atol=CAM_ATOL)
    assert bool(r["iteration_sharded_accept"])
    # shard_problem's check of the problem, then the row-sharded iteration:
    # the blocks' cost, the gradient, G, and the new cost, each one
    # all-reduce; no gather (the points are replicated)
    assert list(r["iteration_kinds"]) == ["all_reduce"] * 5
    assert r["iteration_sizes"][0] == 2 * 3 * len(CHECKED_FIELDS)


@pytest.mark.parametrize("case, single, ref", [
    ("sparse_sharded", "sparse_single", "sparse"),
    ("policy_always", "policy_never", "policy"),
])
def test_sparse_solves(runs, case, single, ref):
    r, _, refs = runs
    assert r[f"{case}_devices"] == WORLD and r[f"{single}_devices"] == 1
    assert r[f"{case}_iters"] == r[f"{single}_iters"]
    np.testing.assert_allclose(r[f"{case}_cost"], r[f"{single}_cost"], rtol=SELF_RTOL)
    jax_res = refs[ref]  # the JAX package's sharded placement (its policy run reports its 8 devices)
    assert ref != "policy" or jax_res.n_devices == 8
    assert r[f"{case}_iters"] == jax_res.n_iterations
    np.testing.assert_allclose(r[f"{case}_cost"], jax_res.cost_final, rtol=COST_RTOL)
    np.testing.assert_allclose(r[f"{case}_cam9"], jax_res.cam9, atol=CAM_ATOL, rtol=0)


def test_shard_policy(runs):
    """'never' and 'auto' below shard_min_obs stay on one placement;
    'always' and 'auto' at shard_min_obs=1 shard over both ranks."""
    r, _, _ = runs
    assert [int(r[f"policy_{p}_devices"]) for p in ("never", "always", "auto", "auto_min1")] == [1, WORLD, 1, WORLD]
    np.testing.assert_allclose(r["policy_auto_min1_cost"], r["policy_never_cost"], rtol=SELF_RTOL)


@pytest.mark.parametrize("case", ["dense", "constrained"])
def test_dense_solves(runs, case):
    r, _, refs = runs
    assert r[f"{case}_sharded_iters"] == r[f"{case}_single_iters"] == refs[case].n_iterations
    atol = CG_CAM_ATOL if case == "constrained" else CAM_ATOL
    np.testing.assert_allclose(r[f"{case}_sharded_cost"], r[f"{case}_single_cost"], rtol=SELF_RTOL)
    np.testing.assert_allclose(r[f"{case}_sharded_cost"], refs[case].cost_final, rtol=COST_RTOL)
    np.testing.assert_allclose(r[f"{case}_sharded_cam9"], refs[case].cam9, atol=atol, rtol=0)
    np.testing.assert_allclose(r[f"{case}_sharded_X"], np.asarray(refs[case].X), atol=atol * 10, rtol=0)
    assert r[f"{case}_sharded_X"].shape == r[f"{case}_single_X"].shape


def test_dense_collectives_per_iteration(runs):
    """The check that the ranks hold the same problem and start (a
    fingerprint of the problem's fields, cam9_0 and X0, their maxima and
    minima in one all-reduce), one all-reduce for the first cost, six of
    point-free sizes an LM iteration, and one all-gather of the points
    after the loop."""
    r, _, _ = runs
    C = r["dense_sharded_cam9"].shape[0]
    kinds, sizes = list(r["dense_kinds"]), list(r["dense_sizes"])
    iters = int(r["dense_sharded_iters"])
    assert kinds == ["all_reduce"] * (2 + 6 * iters) + ["all_gather"]
    per_iteration = [9 * C + 81 * C, 1, 81 * C * C + 9 * C, 1, 2, 2]
    assert sizes[:-1] == [2 * 3 * (len(CHECKED_FIELDS) + 2), 1] + per_iteration * iters


@pytest.mark.parametrize("case", ["values", "shapes"])
def test_ranks_holding_different_problems_raise(runs, case):
    """Rank 1 solves a problem whose uv differ by 1e-9 px ('values') or
    that lacks its last observation ('shapes'): lm_solve raises on both
    ranks (their messages equal, test_the_ranks_agree_bit_for_bit), and the
    cases after it ran."""
    r0, r1, _ = runs
    assert "the ranks hold different bundle-adjustment problems" in str(r0[f"mismatch_{case}"])
    assert str(r1[f"mismatch_{case}"]) == str(r0[f"mismatch_{case}"])


def test_capture_volume_optimize_sharded(runs):
    r, _, refs = runs
    assert r["volume_always_iters"] == r["volume_never_iters"] == refs["volume"].n_iterations
    np.testing.assert_allclose(r["volume_always_cost"], r["volume_never_cost"], rtol=SELF_RTOL)
    np.testing.assert_allclose(r["volume_always_cost"], refs["volume"].cost_final, rtol=COST_RTOL)
    np.testing.assert_allclose(r["volume_always_rmse"], r["volume_never_rmse"], rtol=SELF_RTOL)
    assert r["volume_always_rmse"] < r["volume_rmse0"]
    np.testing.assert_allclose(r["volume_always_cam9"][:, :6], refs["volume"].cam9[:, :6], atol=CAM_ATOL, rtol=0)


@pytest.mark.cuda
def test_sharded_dense_solve_on_cuda():
    """A world-size-1 NCCL mesh on the card: the kernel runs on the rank's
    points and the solve equals the single placement's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    import torch.distributed as dist

    from caliscope_tpu_torch.parallel import make_obs_mesh
    from caliscope_tpu_torch.solvers import fused_schur as FS

    d = inputs()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        problem = TB.make_dense_problem(d["cam_idx"], d["pt_idx"], d["uv"], d["K"], d["dist"], d["fisheye"], n_points=int(d["n_points"]))
        config = TB.BAConfig(max_iter=10, ftol=0.0, gtol=0.0, xtol=0.0, solver="schur")
        single = TB.lm_solve(problem, d["cam9"], d["Xb"], config)
        launches = FS.schur_s_rhs.launches
        sharded = TB.lm_solve(problem, d["cam9"], d["Xb"], config, mesh=make_obs_mesh())
        assert FS.schur_s_rhs.launches - launches == sharded.n_iterations == single.n_iterations
        np.testing.assert_allclose(sharded.cost_final, single.cost_final, rtol=1e-5)
    finally:
        dist.destroy_process_group()
