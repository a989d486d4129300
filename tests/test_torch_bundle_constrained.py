"""The port's constrained bundle adjustment (distance-constraint rows in
caliscope_tpu_torch.solvers.bundle and ops/reprojection.py) held against
the JAX package's on the same problems.

Inputs: a 4-camera ring rig with 40 distance rows between its points (one
in four a centroid row over four points at 0.25 each), weighted as
CaptureVolume.optimize weighs them (tests/torch_ba_common.py), on the dense
layout and on the sparse rows with repeated pairs. Float64 on the CPU,
both sides. Tolerances: constraint residuals and blocks 1e-12; gradient,
diagonal and matvec 1e-9 relative; solves 1e-9 on parameters with the same
LM iterations and the same CG iterations per linear solve.

The 'schur' solve with constraint rows is a CG on the full system that
stops at cg_tol (1e-6 relative residual) — about 40 iterations here — and
the two packages' iterates part by ~1e-8 there (roundoff grown over the
iterations); the whole-solve comparison at 1e-9 runs with cg_tol 1e-10, so
each step is the converged solve, and the default tolerance is held to the
same LM and CG iteration counts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caliscope_tpu.ops import reprojection as JR
from caliscope_tpu.solvers import bundle as JB

from caliscope_tpu_torch.ops import reprojection as TR
from caliscope_tpu_torch.solvers import bundle as TB
from caliscope_tpu_torch.solvers import fused_schur as FS
from torch_ba_common import constraint_rows, jax_counted, ring_rig, sparse_rows

RTOL = 1e-9
ATOL = 1e-12
PARAM_ATOL = 1e-9
DEFAULT_TOL_PARAM_ATOL = 1e-7

j_masked_blocks = jax.jit(JB._masked_blocks, static_argnums=(3, 4, 5))
j_grad_diag = jax.jit(JB._gradient_and_diag, static_argnums=(8, 9, 10))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def case():
    """(rig, constraint arrays, {layout: (JAX problem, port problem)})."""
    rng = np.random.default_rng(21)
    rig = ring_rig(rng, C=4, P=60)
    cam, pt, uv, mask = sparse_rows(rng, rig)
    con = constraint_rows(rng, rig[8], Q=40)
    P = rig[7].shape[0]
    problems = {
        "dense": (
            JB.make_dense_problem(*rig[:6], n_points=P, constraints=con),
            TB.make_dense_problem(*rig[:6], n_points=P, constraints=con, device="cpu"),
        ),
        "sparse": (
            JB.make_problem(cam, pt, uv, *rig[3:6], constraints=con, obs_mask=mask),
            TB.make_problem(cam, pt, uv, *rig[3:6], constraints=con, obs_mask=mask, device="cpu"),
        ),
    }
    return rig, con, problems


def test_constraint_residuals_and_blocks_match_jax(case):
    rig, con, _ = case
    X = rig[7] + 0.003
    want_r = JR.constraint_residuals(jnp.asarray(X), *(jnp.asarray(a) for a in con))
    want = JR.constraint_jacobian_blocks(jnp.asarray(X), *(jnp.asarray(a) for a in con))
    targs = [torch.as_tensor(a) for a in con]
    targs[0], targs[2] = targs[0].long(), targs[2].long()
    close(TR.constraint_residuals(torch.as_tensor(X), *targs), want_r, rtol=1e-12)
    got = TR.constraint_jacobian_blocks(torch.as_tensor(X), *targs)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip((got[0], got[2]), (want[0], want[2])):
        close(g, w, rtol=1e-12)
    # the analytic blocks are the residual's derivative: a central difference
    eps = 1e-6
    for q, k, j in ((0, 0, 1), (3, 2, 0), (7, 5, 2)):
        Xp, Xm = X.copy(), X.copy()
        p = int(got[1][q, k])
        Xp[p, j] += eps
        Xm[p, j] -= eps
        fd = (TR.constraint_residuals(torch.as_tensor(Xp), *targs)[q] - TR.constraint_residuals(torch.as_tensor(Xm), *targs)[q]) / (2 * eps)
        slots = (got[1][q] == p).numpy()
        np.testing.assert_allclose(float(fd), float(got[2][q, slots, j].sum()), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize(
    "layout,obs_minor", [("dense", False), ("sparse", False), ("sparse", True)], ids=["dense", "row_major", "obs_minor"]
)
def test_grad_diag_matvec_with_constraints_match_jax(case, layout, obs_minor):
    rig, _con, problems = case
    jp, tp = problems[layout]
    P = rig[7].shape[0]
    X = rig[7] + 0.002
    want = j_masked_blocks(jp, jnp.asarray(rig[6]), jnp.asarray(X), "soft_l1", 1e-3, obs_minor)
    got = TB._masked_blocks(tp, torch.as_tensor(rig[6]), torch.as_tensor(X), "soft_l1", 1e-3, obs_minor)
    for i in (0, 1, 2, 3, 4, 7):  # r, w, Jc, Jp, rq, cost
        close(got[i], want[i])
    close(got[6], want[6])
    jg = j_grad_diag(jp, want[1], want[0], *want[2:7], P, None, obs_minor)
    plan = TB._make_plan(tp, P, torch.float64)
    tg = TB._gradient_and_diag(tp, plan, got[1], got[0], *got[2:7], obs_minor)
    for g, w in zip(tg, jg):
        close(g, w)
    rng = np.random.default_rng(5)
    vc, vp = rng.normal(size=(4, 9)), rng.normal(size=(P, 3))
    jmv = jax.jit(JB._hessian_matvec_obs_minor if obs_minor else JB._hessian_matvec)(
        jp, want[1], want[2], want[3], want[5], want[6], jnp.asarray(vc), jnp.asarray(vp)
    )
    tmv = TB._hessian_matvec(tp, plan, got[1], got[2], got[3], got[5], got[6], torch.as_tensor(vc), torch.as_tensor(vp), obs_minor)
    for g, w in zip(tmv, jmv):
        close(g, w)


LM_CASES = [
    ("dense", "dense", False), ("dense", "schur", False), ("dense", "cg", False),
    ("sparse", "dense", False), ("sparse", "schur", False), ("sparse", "schur", True), ("sparse", "cg", True),
]


@pytest.mark.parametrize("layout,solver,obs_minor", LM_CASES, ids=["-".join(map(str, c)) for c in LM_CASES])
def test_constrained_lm_solve_matches_jax(case, layout, solver, obs_minor):
    rig, _con, problems = case
    jp, tp = problems[layout]
    cfg = dict(solver=solver, obs_minor="always" if obs_minor else "never", max_iter=30, cg_tol=1e-10)
    want = JB.lm_solve(jp, rig[6], rig[7], JB.BAConfig(**cfg))
    got = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(**cfg))
    assert got.solver == solver and not got.fused_schur
    assert got.n_iterations == want.n_iterations and got.converged == want.converged
    np.testing.assert_allclose(got.cost_initial, want.cost_initial, rtol=1e-12)
    np.testing.assert_allclose(got.cost_final, want.cost_final, rtol=1e-9)
    np.testing.assert_allclose(got.cam9, want.cam9, atol=PARAM_ATOL, rtol=0)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_constrained_schur_at_default_cg_tol(case, layout):
    """The solve as the pipeline runs it (cg_tol 1e-6): the same LM
    iterations, the first step's CG iterations equal to the JAX
    while-loop's, and the optimum within 1e-7."""
    rig, _con, problems = case
    jp, tp = problems[layout]
    want = JB.lm_solve(jp, rig[6], rig[7], JB.BAConfig(solver="schur"))
    got = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(solver="schur"))
    assert got.n_iterations == want.n_iterations and len(got.cg_iterations) == got.n_iterations
    np.testing.assert_allclose(got.cam9, want.cam9, atol=DEFAULT_TOL_PARAM_ATOL, rtol=0)
    np.testing.assert_allclose(got.cost_final, want.cost_final, rtol=1e-9)

    P = rig[7].shape[0]
    jb = j_masked_blocks(jp, jnp.asarray(rig[6]), jnp.asarray(rig[7]), "linear", 1.0, False)
    jg = j_grad_diag(jp, jb[1], jb[0], *jb[2:7], P, None, False)
    lam = JB.BAConfig().init_lambda
    jdx, count = jax_counted(
        lambda p, w, Jc, Jp, qi, Jq, gc, gp, dc, dp, lm: JB._solve_schur(p, w, Jc, Jp, qi, Jq, gc, gp, dc, dp, lm, 1e-6, 200, None, False, False),
        jp, jb[1], jb[2], jb[3], jb[5], jb[6], *jg, jnp.asarray(lam),
    )
    tb = TB._masked_blocks(tp, torch.as_tensor(rig[6]), torch.as_tensor(rig[7]), "linear", 1.0, False)
    plan = TB._make_plan(tp, P, torch.float64)
    tg = TB._gradient_and_diag(tp, plan, tb[1], tb[0], *tb[2:7], False)
    *tdx, it = TB._solve_schur(tp, plan, tb[1], tb[2], tb[3], tb[5], tb[6], *tg, torch.tensor(lam, dtype=torch.float64), 1e-6, 200)
    assert 1 < int(it) == count == got.cg_iterations[0] < 200
    for g, w in zip(tdx, jdx):  # steps of ~1e-2, iterates ~1e-8 apart (see the module docstring)
        close(g, w, rtol=0, atol=1e-8)


def test_dense_and_sparse_layouts_agree(case):
    """The same constrained problem on both layouts reaches the same
    optimum (the JAX package's own check, tests/test_bundle.py), here with
    the sparse rows' duplicates left out so the problems are one."""
    rig, con, _ = case
    P = rig[7].shape[0]
    dense = TB.make_dense_problem(*rig[:6], n_points=P, constraints=con, device="cpu")
    sparse = TB.make_problem(*rig[:6], constraints=con, device="cpu")
    cfg = TB.BAConfig(solver="schur", max_iter=20, ftol=1e-12, gtol=0.0, cg_tol=1e-10)
    a = TB.lm_solve(sparse, rig[6], rig[7], cfg)
    b = TB.lm_solve(dense, rig[6], rig[7], cfg)
    np.testing.assert_allclose(b.cost_final, a.cost_final, rtol=1e-9)
    np.testing.assert_allclose(b.cam9, a.cam9, atol=1e-9)


def test_refusals_on_constrained_problems(case):
    """schur_cg is reprojection-only; the fused Schur kernel takes neither
    constrained nor sparse problems, and asking for it raises instead of
    skipping it; a baked solve is the unbaked one; without a process group
    shard='always' solves on a single placement, and a mesh must be a
    parallel.Mesh."""
    rig, _con, problems = case
    for layout in ("dense", "sparse"):
        tp = problems[layout][1]
        with pytest.raises(ValueError, match="reprojection-only"):
            TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(solver="schur_cg"))
        with pytest.raises(ValueError, match="fused Schur kernel"):
            TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(solver="schur"), fused_schur=True)
    launches = FS.schur_s_rhs.launches
    got = TB.lm_solve(problems["dense"][1], rig[6], rig[7], TB.BAConfig(solver="schur", max_iter=2))
    assert not got.fused_schur and FS.schur_s_rhs.launches == launches
    assert TB.lm_solve(problems["sparse"][1], rig[6], rig[7], TB.BAConfig(shard="always", max_iter=2)).n_devices == 1
    baked = TB.lm_solve(problems["sparse"][1], rig[6], rig[7], TB.BAConfig(bake_problem=True, max_iter=2))
    unbaked = TB.lm_solve(problems["sparse"][1], rig[6], rig[7], TB.BAConfig(max_iter=2))
    np.testing.assert_array_equal(baked.cam9, unbaked.cam9)
    assert torch.equal(baked.X, unbaked.X) and baked.cg_iterations == unbaked.cg_iterations
    with pytest.raises(TypeError, match="Mesh"):
        TB.lm_solve(problems["sparse"][1], rig[6], rig[7], mesh=object())
