"""The port's sparse row layout (caliscope_tpu_torch.solvers.bundle:
make_problem, the row-major and obs-minor blocks, reductions, Schur factors
and every linear solver) held against the JAX package's on the same rows.

Inputs: a 4-camera ring rig (tests/torch_ba_common.py) whose rows come
shuffled, with repeated (point, camera) pairs (a static marker's corners
seen in many frames) and masked padding rows. Float64 on the CPU, both
sides; the JAX package runs its row-major layout (its CPU default) or its
obs-minor one (obs_minor='always'), the port the same. Tolerances: row
order and indices bit for bit; blocks and reductions 1e-9 relative (closed
form against jacfwd, sums in another order); solves 1e-9 on parameters
with the same LM iterations and the same CG iterations per linear solve.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caliscope_tpu.ops import reprojection as JR
from caliscope_tpu.solvers import bundle as JB

from caliscope_tpu_torch import convert
from caliscope_tpu_torch.ops import reprojection as TR
from caliscope_tpu_torch.solvers import bundle as TB
from torch_ba_common import jax_counted, ring_rig, sparse_rows

RTOL = 1e-9
ATOL = 1e-12
PARAM_ATOL = 1e-9
LAYOUTS = [False, True]
LAYOUT_IDS = ["row_major", "obs_minor"]


# the JAX package's building blocks compiled once each (vmapped jacfwd runs
# op by op for seconds when called eagerly)
j_obs_blocks = jax.jit(JR.observation_jacobian_blocks, static_argnums=9)
j_masked_blocks = jax.jit(JB._masked_blocks, static_argnums=(3, 4, 5))
j_grad_diag = jax.jit(JB._gradient_and_diag, static_argnums=(8, 9, 10))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def case():
    """(rig, rows, JAX problem, port problem)."""
    rng = np.random.default_rng(11)
    rig = ring_rig(rng, C=4, P=60)
    rows = sparse_rows(rng, rig)
    cam, pt, uv, mask = rows
    jp = JB.make_problem(cam, pt, uv, rig[3], rig[4], rig[5], obs_mask=mask)
    tp = TB.make_problem(cam, pt, uv, rig[3], rig[4], rig[5], obs_mask=mask, device="cpu")
    return rig, rows, jp, tp


def start(rig):
    return torch.as_tensor(rig[6]), torch.as_tensor(rig[7])


def test_make_problem_row_order_bit_equal(case):
    rig, (cam, pt, uv, mask), jp, tp = case
    assert tp.n_obs == jp.n_obs and tp.n_cameras == jp.n_cameras and tp.n_constraints == 0
    for name in convert.BA_PROBLEM_FIELDS:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)
    assert tp.any_fisheye == jp.any_fisheye
    # sorted by (point, camera), duplicates kept in their input order
    key = tp.pt_idx.numpy() * 4 + tp.cam_idx.numpy()
    assert np.all(np.diff(key) >= 0) and len(np.unique(key)) < len(key)
    # the same problem carried across from the JAX package's arrays
    carried = convert.ba_problem({f: np.asarray(getattr(jp, f)) for f in convert.BA_PROBLEM_FIELDS}, device="cpu")
    for name in convert.BA_PROBLEM_FIELDS:
        assert torch.equal(getattr(carried, name), getattr(tp, name)), name
    # already-sorted rows are kept as they are
    again = TB.make_problem(tp.cam_idx.numpy(), tp.pt_idx.numpy(), tp.uv.numpy(), rig[3], rig[4], rig[5],
                            obs_mask=tp.obs_mask.numpy(), device="cpu")
    assert torch.equal(again.uv, tp.uv)


@pytest.mark.parametrize("any_fisheye", [True, False], ids=["mixed_rig", "brown_only"])
def test_observation_blocks_match_jax(case, any_fisheye):
    """Row-major and obs-minor residuals and blocks against the JAX
    package's jacfwd blocks on the same rows."""
    rig, _rows, jp, tp = case
    cam9, X = start(rig)
    jargs = (jnp.asarray(rig[6]), jnp.asarray(rig[7]), jp.cam_idx, jp.pt_idx)
    jtail = (jp.K0, jp.dist0, jp.fisheye, jp.inv_fx, any_fisheye)
    targs = (cam9, X, tp.cam_idx, tp.pt_idx)
    ttail = (tp.K0, tp.dist0, tp.fisheye, tp.inv_fx, any_fisheye)
    want = j_obs_blocks(*jargs, jp.uv, *jtail)
    rows = TR.observation_jacobian_blocks(*targs, tp.uv, *ttail)
    minor = TR.observation_blocks_obs_minor(*targs, tp.uv.T, *ttail)
    for got_r, got_m, w in zip(rows, minor, want):
        close(got_r, w)
        close(got_m.permute(got_m.dim() - 1, *range(got_m.dim() - 1)), w)
    close(TR.observation_residuals(*targs, tp.uv, *ttail), want[0])
    close(TR.observation_residuals_obs_minor(*targs, tp.uv.T, *ttail), np.asarray(want[0]).T)


@pytest.mark.parametrize("obs_minor", LAYOUTS, ids=LAYOUT_IDS)
def test_grad_diag_matvec_match_jax(case, obs_minor):
    rig, _rows, jp, tp = case
    cam9, X = start(rig)
    P = X.shape[0]
    want = j_masked_blocks(jp, jnp.asarray(rig[6]), jnp.asarray(rig[7]), "soft_l1", 1e-3, obs_minor)
    got = TB._masked_blocks(tp, cam9, X, "soft_l1", 1e-3, obs_minor=obs_minor)
    for i in (0, 1, 2, 3, 7):  # r, w, Jc, Jp, cost
        close(got[i], want[i])
    jg = j_grad_diag(jp, want[1], want[0], *want[2:7], P, None, obs_minor)
    plan = TB._make_plan(tp, P, torch.float64)
    tg = TB._gradient_and_diag(tp, plan, got[1], got[0], *got[2:7], obs_minor=obs_minor)
    for g, w in zip(tg, jg):  # g_c, g_p, d_c, d_p (obs-minor d_p point-minor on both sides)
        close(g, w)
    rng = np.random.default_rng(2)
    vc, vp = rng.normal(size=(4, 9)), rng.normal(size=(P, 3))
    jmv = jax.jit(JB._hessian_matvec_obs_minor if obs_minor else JB._hessian_matvec)(
        jp, want[1], want[2], want[3], want[5], want[6], jnp.asarray(vc), jnp.asarray(vp)
    )
    tmv = TB._hessian_matvec(tp, plan, got[1], got[2], got[3], got[5], got[6], torch.as_tensor(vc), torch.as_tensor(vp), obs_minor)
    for g, w in zip(tmv, jmv):
        close(g, w)


def _linearized(case, obs_minor):
    """Both packages' first-iteration linearization (linear loss) and the
    port's plan."""
    rig, _rows, jp, tp = case
    cam9, X = start(rig)
    P = X.shape[0]
    jb = j_masked_blocks(jp, jnp.asarray(rig[6]), jnp.asarray(rig[7]), "linear", 1.0, obs_minor)
    jg = j_grad_diag(jp, jb[1], jb[0], *jb[2:7], P, None, obs_minor)
    tb = TB._masked_blocks(tp, cam9, X, "linear", 1.0, obs_minor=obs_minor)
    plan = TB._make_plan(tp, P, torch.float64)
    tg = TB._gradient_and_diag(tp, plan, tb[1], tb[0], *tb[2:7], obs_minor=obs_minor)
    return jb, jg, tb, tg, plan


@pytest.mark.parametrize("obs_minor", LAYOUTS, ids=LAYOUT_IDS)
def test_schur_factors_match_jax(case, obs_minor):
    """G, Y, Hpp^-1 and the Schur solve of one damped system."""
    _rig, _rows, jp, tp = case
    jb, jg, tb, tg, plan = _linearized(case, obs_minor)
    lam = 1e-3
    jfac = jax.jit(JB._schur_factors_obs_minor if obs_minor else JB._schur_factors)(
        jp, jb[1], jb[2], jb[3], *jg, jnp.asarray(lam)
    )
    jfac = ((jfac[0][0], False), *jfac[1:])  # cho_factor's upper factor; its flag comes back as an array
    tfac = TB._schur_factors(tp, plan, tb[1], tb[2], tb[3], tg[2], tg[3], torch.tensor(lam, dtype=torch.float64), obs_minor)
    assert tfac[5] == obs_minor
    for g, w in zip(tfac[1:4], jfac[1:4]):  # G, Y, Hpp_inv in the layout's own order
        close(g, w)
    S_t = tfac[0] @ tfac[0].T
    c, _lower = jfac[0]
    S_j = np.triu(np.asarray(c)).T @ np.triu(np.asarray(c))
    close(S_t, S_j)
    jdx = JB._schur_apply(*jfac, -jg[0], -jg[1], pminor=obs_minor)
    tdx = TB._schur_apply(tfac, -tg[0], -tg[1])
    for g, w in zip(tdx, jdx):
        close(g, w)


SOLVERS = ["dense", "schur", "schur_cg", "cg"]


@pytest.mark.parametrize("obs_minor", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("solver", SOLVERS)
def test_lm_solve_matches_jax(case, solver, obs_minor):
    rig, _rows, jp, tp = case
    cfg = dict(solver=solver, obs_minor="always" if obs_minor else "never", max_iter=30)
    want = JB.lm_solve(jp, rig[6], rig[7], JB.BAConfig(**cfg))
    got = TB.lm_solve(tp, rig[6], rig[7], TB.BAConfig(**cfg))
    assert got.solver == solver and got.obs_minor == obs_minor and not got.fused_schur
    assert got.n_iterations == want.n_iterations and got.converged == want.converged
    assert len(got.cg_iterations) == (got.n_iterations if solver in ("schur_cg", "cg") else 0)
    np.testing.assert_allclose(got.cost_initial, want.cost_initial, rtol=1e-12)
    np.testing.assert_allclose(got.cost_final, want.cost_final, rtol=1e-9)
    np.testing.assert_allclose(got.cam9, want.cam9, atol=PARAM_ATOL, rtol=0)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("obs_minor", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("solver", ["schur_cg", "cg"])
def test_cg_solve_iterations_match_jax(case, solver, obs_minor):
    """One damped linear solve: the same step and the same count of CG
    iterations as the JAX package's while-loop."""
    _rig, _rows, jp, tp = case
    jb, jg, tb, tg, plan = _linearized(case, obs_minor)
    lam, tol, max_iter = 1e-3, 1e-6, 200
    tlam = torch.tensor(lam, dtype=torch.float64)
    if solver == "cg":
        (jdx, count) = jax_counted(
            lambda p, w, Jc, Jp, gc, gp, dc, dp, lm: JB._solve_cg(p, w, Jc, Jp, jb[5], jb[6], gc, gp, dc, dp, lm, tol, max_iter, obs_minor),
            jp, jb[1], jb[2], jb[3], *jg, jnp.asarray(lam),
        )
        *tdx, it = TB._solve_cg(tp, plan, tb[1], tb[2], tb[3], tb[5], tb[6], *tg, tlam, tol, max_iter, obs_minor)
    else:
        (jdx, count) = jax_counted(
            lambda p, w, Jc, Jp, gc, gp, dc, dp, lm: JB._solve_schur_cg(p, w, Jc, Jp, gc, gp, dc, dp, lm, tol, max_iter, None, obs_minor),
            jp, jb[1], jb[2], jb[3], *jg, jnp.asarray(lam),
        )
        *tdx, it = TB._solve_schur_cg(tp, plan, tb[1], tb[2], tb[3], *tg, tlam, tol, max_iter, obs_minor)
    assert 1 < int(it) == count < max_iter
    for g, w in zip(tdx, jdx):
        close(g, w, atol=1e-11)


def test_auto_policy(case):
    """'auto' picks dense under dense_cutoff, the explicit Schur factors up
    to 1 GiB, past it schur_cg (cg with constraint rows); the obs-minor
    layout is row-major on the CPU under 'auto', as in the JAX package."""
    _rig, _rows, jp, tp = case
    cfg = TB.BAConfig()
    assert TB._solver_kind(tp, cfg, 4, 60) == "dense"
    assert TB._solver_kind(tp, cfg, 8, 35_000) == "schur"
    # 2 * C * P * 27 float64 bytes past 1 GiB
    big = (1 << 30) // (2 * 8 * 27 * 8) + 1
    assert TB._solver_kind(tp, cfg, 8, big) == "schur_cg"
    assert TB._solver_kind(tp, cfg, 8, big - 1) == "schur"
    constrained = TB.make_problem([0], [0], np.zeros((1, 2)), np.eye(3)[None], np.zeros((1, 5)), [False],
                                  constraints=(np.zeros((1, 4)), np.eye(4)[:1], np.zeros((1, 4)), np.eye(4)[:1], [1.0], [1.0]),
                                  device="cpu")
    assert TB._solver_kind(constrained, cfg, 8, big) == "cg"
    assert TB._solver_kind(tp, TB.BAConfig(solver="cg"), 4, 60) == "cg"
    with pytest.raises(ValueError, match="Unknown solver"):
        TB._solver_kind(tp, TB.BAConfig(solver="lu"), 4, 60)
    assert not TB._use_obs_minor(tp, "auto") and not JB._use_obs_minor(jp, None, "auto")
    assert TB._use_obs_minor(tp, "always") and not TB._use_obs_minor(tp, "never")
    with pytest.raises(ValueError, match="obs_minor"):
        TB._use_obs_minor(tp, "sometimes")
    dense = TB.make_dense_problem([0], [0], np.zeros((1, 2)), np.eye(3)[None], np.zeros((1, 5)), [False], n_points=1, device="cpu")
    assert not TB._use_obs_minor(dense, "always")


def test_duplicate_pairs_rejected_by_the_dense_layout():
    K = np.tile(np.eye(3) * 100.0, (2, 1, 1))
    K[:, 2, 2] = 1.0
    with pytest.raises(ValueError, match="duplicates"):
        TB.make_dense_problem(
            np.array([0, 0]), np.array([1, 1]), np.zeros((2, 2)), K, np.zeros((2, 5)), np.zeros(2, bool), n_points=4,
            device="cpu",
        )
    # the sparse layout takes them
    p = TB.make_problem(np.array([0, 0]), np.array([1, 1]), np.zeros((2, 2)), K, np.zeros((2, 5)), np.zeros(2, bool), device="cpu")
    assert p.n_obs == 2


@pytest.mark.cuda
@pytest.mark.parametrize("obs_minor", LAYOUTS, ids=LAYOUT_IDS)
def test_sparse_solve_on_cuda(case, obs_minor):
    """The sparse solve on the card: the CPU optimum to float32 roundoff,
    and the same bits when solved again (no atomics in its reductions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    rig, (cam, pt, uv, mask), _jp, tp = case
    gp = TB.make_problem(cam, pt, uv, rig[3], rig[4], rig[5], obs_mask=mask)  # cuda, float32
    cfg = TB.BAConfig(solver="schur", obs_minor="always" if obs_minor else "never")
    want = TB.lm_solve(tp, rig[6], rig[7], cfg)
    a, b = TB.lm_solve(gp, rig[6], rig[7], cfg), TB.lm_solve(gp, rig[6], rig[7], cfg)
    np.testing.assert_allclose(a.cost_final, want.cost_final, rtol=1e-4)
    assert np.array_equal(a.cam9, b.cam9) and torch.equal(a.X, b.X)
