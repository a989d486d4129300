"""The port's LM bundle adjustment (caliscope_tpu_torch.solvers.bundle) held
against the JAX package's on the same dense problem.

Float64 on the CPU, both sides. The solvers evaluate the same expressions
in different summation orders, so per-iteration values agree to roundoff;
over a short convergent solve that stays far below the tolerances:
iterations equal, cost_final to 1e-9 relative, cam9 and X to 1e-8 absolute
(radians, meters, and the unitless [s, k1, k2]).

Float32 (the card's type), the kernel branch of the Schur solve runs here
through the wrapper's plain version; it must reach the JAX package's f32
optimum to 1e-4 relative cost (f32 sums in another order drift the
trajectory at roundoff, as the JAX package's own kernel-vs-XLA test allows).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caliscope_tpu.solvers import bundle as JB
from caliscope_tpu_torch.solvers import bundle as TB
from caliscope_tpu_torch.solvers import fused_schur as FS


def _rig(rng, C=4, P=120):
    """A ring rig with noisy observations of ~70 % of the (point, camera)
    grid, perturbed starting cameras and points, one fisheye camera."""
    K0, dist0, Rs, ts = [], [], [], []
    for i in range(C):
        a = 2 * np.pi * i / C
        c = np.array([2.5 * np.cos(a), 2.5 * np.sin(a), 0.8])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Rs.append(R)
        ts.append(-R @ c)
        K0.append([[800.0, 0, 640], [0, 800.0, 360], [0, 0, 1]])
        dist0.append([0.05, -0.02, 0.001, 0.0005, 0.0] if i != 1 else [0.02, -0.01, 0.003, -0.001, 0.0])
    K0, dist0, fe = np.asarray(K0), np.asarray(dist0), np.arange(C) == 1
    X = rng.uniform(-0.6, 0.6, size=(P, 3))
    grid = rng.uniform(size=(P, C)) < 0.7
    grid[:, :2] = True
    pt_idx, cam_idx = np.nonzero(grid)
    from caliscope_tpu.ops.lie import so3_log

    cam9 = np.concatenate(
        [np.asarray(so3_log(jnp.asarray(np.stack(Rs)))), np.asarray(ts), np.ones((C, 1)), dist0[:, :2]], axis=1
    )
    from caliscope_tpu.ops.reprojection import project_with_block

    uv = np.asarray(
        project_with_block(
            jnp.asarray(X[pt_idx]), jnp.asarray(cam9[cam_idx]), jnp.asarray(K0[cam_idx]),
            jnp.asarray(dist0[cam_idx]), jnp.asarray(fe[cam_idx]),
        )
    ) + rng.normal(scale=0.5, size=(len(pt_idx), 2))
    cam9_0 = cam9 + np.concatenate([rng.normal(scale=0.01, size=(C, 6)), np.zeros((C, 3))], axis=1)
    X0 = X + rng.normal(scale=0.01, size=X.shape)
    return cam_idx, pt_idx, uv, K0, dist0, fe, cam9_0, X0


@pytest.fixture(scope="module")
def rig():
    return _rig(np.random.default_rng(3))


def _problems(rig, dtype_np, dtype_t, refine):
    cam_idx, pt_idx, uv, K0, dist0, fe, _, X0 = rig
    P = X0.shape[0]
    jp = JB.make_dense_problem(cam_idx, pt_idx, uv, K0, dist0, fe, n_points=P, refine_intrinsics=refine, dtype=dtype_np)
    tp = TB.make_dense_problem(
        cam_idx, pt_idx, uv, K0, dist0, fe, n_points=P, refine_intrinsics=refine, dtype=dtype_t, device="cpu"
    )
    return jp, tp


@pytest.mark.parametrize("loss", ["linear", "soft_l1"])
@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_lm_solve_matches_jax_f64(rig, solver, loss):
    refine = loss == "soft_l1"  # the robust stage refines intrinsics, as in the pipeline
    jp, tp = _problems(rig, jnp.float64, torch.float64, refine)
    cam9_0, X0 = rig[6], rig[7]
    cfg = dict(solver=solver, loss=loss, f_scale=1.0 / 800.0)
    want = JB.lm_solve(jp, cam9_0, X0, JB.BAConfig(**cfg))
    got = TB.lm_solve(tp, cam9_0, X0, TB.BAConfig(**cfg))
    assert got.solver == solver and not got.fused_schur  # CPU float64: no kernel
    assert got.n_iterations == want.n_iterations
    assert got.converged == want.converged
    np.testing.assert_allclose(got.cost_initial, want.cost_initial, rtol=1e-12)
    np.testing.assert_allclose(got.cost_final, want.cost_final, rtol=1e-9)
    np.testing.assert_allclose(got.cam9, want.cam9, atol=1e-8)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), atol=1e-8)
    assert isinstance(got.X, torch.Tensor) and got.X.device.type == "cpu"


def test_auto_policy_and_fixed_iterations(rig):
    """'auto' takes the dense solver at calibration size; with ftol/gtol at 0
    the loop runs exactly max_iter iterations on both sides."""
    jp, tp = _problems(rig, jnp.float64, torch.float64, False)
    cam9_0, X0 = rig[6], rig[7]
    cfg = dict(max_iter=4, ftol=0.0, xtol=0.0, gtol=0.0)
    want = JB.lm_solve(jp, cam9_0, X0, JB.BAConfig(**cfg))
    got = TB.lm_solve(tp, cam9_0, X0, TB.BAConfig(**cfg))
    assert got.solver == "dense" and got.n_iterations == want.n_iterations == 4
    np.testing.assert_allclose(got.cost_final, want.cost_final, rtol=1e-10)
    np.testing.assert_allclose(got.gradient_norm, want.gradient_norm, rtol=1e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["fused_branch", "plain_assembly"])
def test_schur_f32_matches_jax_f32(rig, fused):
    jp, tp = _problems(rig, jnp.float32, torch.float32, False)
    cam9_0, X0 = rig[6], rig[7]
    want = JB.lm_solve(jp, cam9_0, X0, JB.BAConfig(solver="schur"))
    before = FS.schur_s_rhs.launches
    got = TB.lm_solve(tp, cam9_0, X0, TB.BAConfig(solver="schur"), fused_schur=fused)
    assert FS.schur_s_rhs.launches == before  # CPU: the plain version, no kernel launch
    assert got.fused_schur == fused
    np.testing.assert_allclose(got.cost_final, want.cost_final, rtol=1e-4)
    np.testing.assert_allclose(got.cam9[:, :6], want.cam9[:, :6], atol=1e-3)


@pytest.mark.parametrize("refine", [False, True], ids=["poses", "intrinsics"])
def test_schur_solve_equals_dense_solve_f64(rig, refine):
    """The Schur-eliminated solve (S, rhs and Hpp^-1 from the plain
    assembly, G^T dx recomputed from the blocks) and the full Cholesky solve
    give the same step for the same damped system, frozen parameters
    included; 1e-7 relative allows for the two factorizations' roundoff."""
    _, tp = _problems(rig, jnp.float64, torch.float64, refine)
    cam9 = torch.as_tensor(rig[6])
    X = torch.as_tensor(rig[7])
    r, w, Jc, Jp, _ = TB._masked_blocks_dense(tp, cam9, X, "linear", 1.0)
    g_c, g_p, d_c = TB._gradient_and_diag_dense(w, r, Jc, Jp)
    lam = torch.tensor(1e-3, dtype=torch.float64)
    plan = TB._make_plan(tp, X.shape[0], torch.float64)
    schur = TB._solve_schur(tp, plan, w, Jc, Jp, None, None, g_c, g_p, d_c, None, lam, 1e-6, 200, fused=False)[:2]
    dense = TB._solve_dense(tp, plan, w, Jc, Jp, None, None, g_c, g_p, d_c, None, lam)
    for a, b in zip(schur, dense):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7, atol=1e-10)


def test_unported_paths_raise(rig):
    """The 'cg' and 'schur_cg' solvers, constraint rows and the sparse row
    layout are ported: each solves the rig to the dense Schur optimum.
    What is not a problem, and the fused kernel where it cannot run (CPU
    float64; a constrained or sparse problem), still raise."""
    jp, tp = _problems(rig, jnp.float64, torch.float64, False)
    cam9_0, X0 = rig[6], rig[7]
    ref = TB.lm_solve(tp, cam9_0, X0, TB.BAConfig(solver="schur"))
    for solver in ("cg", "schur_cg"):
        got = TB.lm_solve(tp, cam9_0, X0, TB.BAConfig(solver=solver))
        assert got.solver == solver and len(got.cg_iterations) == got.n_iterations
        np.testing.assert_allclose(got.cost_final, ref.cost_final, rtol=1e-6)
    con = (np.zeros((1, 4)), np.eye(4)[:1], np.ones((1, 4)), np.eye(4)[:1], np.array([0.05]), np.array([10.0]))
    constrained = TB.make_dense_problem(*rig[:6], n_points=X0.shape[0], constraints=con, device="cpu")
    assert constrained.n_constraints == 1
    sparse = TB.make_problem(*rig[:6], device="cpu")
    got = TB.lm_solve(sparse, cam9_0, X0, TB.BAConfig(solver="schur"))
    np.testing.assert_allclose(got.cost_final, ref.cost_final, rtol=1e-9)
    with pytest.raises(TypeError, match="BAProblem"):
        TB.lm_solve(object(), cam9_0, X0)
    with pytest.raises(TypeError, match="float32"):
        TB.lm_solve(tp, cam9_0, X0, TB.BAConfig(solver="schur"), fused_schur=True)
    for problem in (constrained, sparse):
        with pytest.raises(ValueError, match="fused Schur kernel"):
            TB.lm_solve(problem, cam9_0, X0, TB.BAConfig(solver="schur"), fused_schur=True)


def test_bound_warnings_match_jax():
    cam9 = np.zeros((3, 9))
    cam9[:, 6] = [1.0, 0.501, 1.99]
    cam9[:, 7] = [0.0, 0.995, -0.2]
    cam9[:, 8] = [1.999, 0.0, 0.0]
    assert TB.bound_warnings(cam9) == JB.bound_warnings(cam9)
