"""Bundle adjustment as Levenberg-Marquardt on the dense point-minor layout.

Port of the dense, reprojection-only half of caliscope_tpu/solvers/bundle.py:
the (C, P) observation grid with the long point axis minor, IRLS robust
weights, the 'dense' (full Cholesky) and 'schur' (point elimination)
linear solvers, gain-ratio damping and scipy-style termination with the
same expressions as the JAX package.

Where the JAX package runs the whole loop as one `lax.while_loop`, this port
runs a Python loop over device tensors. The solver state (cameras, points,
damping, cost) stays on the device; the loop reads one termination flag back
to the host per iteration, and the result is one small readback of the
camera blocks and scalars (the points stay on the device, BAResult.X).

The Schur solve assembles S, its right-hand side and the inverse point
blocks with the fused kernel (solvers/fused_schur.py) whenever the problem
is one the kernel takes (`fused_schur=None`, the default), or as the caller
says (`fused_schur=True/False`), and with its plain PyTorch version
otherwise. On CUDA float32 problems the default is the kernel.

Not ported yet (each raises NotImplementedError naming its ROADMAP.md item):
the sparse row and obs-minor layouts, the 'cg' and 'schur_cg' solvers,
constraint rows and observation-axis sharding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from caliscope_tpu_torch.device import resolve_device, resolve_dtype
from caliscope_tpu_torch.ops.reprojection import (
    N_CAM_PARAMS,
    dense_observation_jacobian_blocks,
    dense_observation_residuals,
    robust_weights_and_cost,
)
from caliscope_tpu_torch.solvers.fused_schur import fused_schur_available, schur_s_rhs, schur_s_rhs_plain

# Free-intrinsics bounds: s in [0.5, 2], k1 in [-1, 1], k2 in [-2, 2].
INTRINSIC_LOWER = np.array([0.5, -1.0, -2.0])
INTRINSIC_UPPER = np.array([2.0, 1.0, 2.0])
BIG = 1e20


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to caliscope_tpu_torch yet (ROADMAP.md queue 1: {item})")


@dataclass(frozen=True)
class BAConfig:
    """Solver configuration."""

    loss: str = "linear"  # 'linear' | 'soft_l1'
    f_scale: float = 1.0  # robust inlier scale, in normalized residual units
    max_iter: int = 200
    ftol: float = 1e-8
    xtol: float = 1e-10
    gtol: float = 1e-12
    solver: str = "auto"  # 'auto' | 'dense' | 'schur'
    init_lambda: float = 1e-4
    # 'auto' picks dense when 9C + 3P <= dense_cutoff
    dense_cutoff: int = 6000


@dataclass
class BADenseProblem:
    """Bundle-adjustment problem in the dense (C, P) observation layout,
    point-minor, as device tensors. Unobserved (camera, point) slots carry
    obs_mask=False and contribute exact zeros."""

    uv: torch.Tensor  # (C, 2, P) pixels
    obs_mask: torch.Tensor  # (C, P) bool
    K0: torch.Tensor  # (C,3,3)
    dist0: torch.Tensor  # (C,5)
    fisheye: torch.Tensor  # (C,) bool
    inv_fx: torch.Tensor  # (C,)
    param_free: torch.Tensor  # (C,9) bool
    any_fisheye: bool = True

    @property
    def n_cameras(self) -> int:
        return self.K0.shape[0]

    @property
    def n_points(self) -> int:
        return self.uv.shape[2]

    @property
    def n_constraints(self) -> int:
        return 0  # constraint rows are not ported yet (make_dense_problem refuses them)


def make_problem(*args, **kwargs):
    raise not_ported("The sparse row layout (make_problem)", "item 16, sparse row and obs-minor layouts")


def make_dense_problem(
    cam_idx,
    pt_idx,
    uv,
    K0,
    dist0,
    fisheye,
    n_points: int,
    refine_intrinsics: bool = False,
    fixed_cameras=None,
    constraints=None,
    obs_mask=None,
    dtype=None,
    device=None,
) -> BADenseProblem:
    """Build a BADenseProblem by scattering sparse observation rows into the
    (n_points, C) grid host-side, then moving it to `device` (CUDA unless
    named). Requires every unmasked (pt, cam) pair to be unique. Rows with
    pt_idx >= n_points or obs_mask=False are dropped."""
    if constraints is not None:
        raise not_ported("Constraint rows in bundle adjustment", "item 13, constraints and constrained BA")
    device = resolve_device(device)
    dtype = resolve_dtype(device, dtype)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    C = np.asarray(K0).shape[0]
    cam_idx = np.asarray(cam_idx, np.int64)
    pt_idx = np.asarray(pt_idx, np.int64)
    uv = np.asarray(uv)
    keep = pt_idx < n_points
    if obs_mask is not None:
        keep = keep & np.asarray(obs_mask, bool)
    cam_k, pt_k, uv_k = cam_idx[keep], pt_idx[keep], uv[keep]
    flat = pt_k * C + cam_k
    if len(np.unique(flat)) != len(flat):
        raise ValueError(
            "dense layout needs one observation per (point, camera) pair; "
            "this problem has duplicates (static objects?) — use make_problem"
        )
    grid_uv = np.zeros((n_points, C, 2), np_dtype)
    grid_mask = np.zeros((n_points, C), bool)
    grid_uv[pt_k, cam_k] = uv_k
    grid_mask[pt_k, cam_k] = True

    param_free = np.zeros((C, N_CAM_PARAMS), bool)
    param_free[:, :6] = True
    if fixed_cameras is not None:
        param_free[np.asarray(fixed_cameras, bool), :6] = False
    if refine_intrinsics:
        param_free[:, 6:] = True
    fx = np.asarray(K0)[:, 0, 0]

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=device, dtype=dt)

    return BADenseProblem(
        uv=dev(grid_uv.transpose(1, 2, 0)),
        obs_mask=dev(grid_mask.T, torch.bool),
        K0=dev(np.asarray(K0, np.float64)),
        dist0=dev(np.asarray(dist0, np.float64)),
        fisheye=dev(np.asarray(fisheye, bool), torch.bool),
        inv_fx=dev(1.0 / fx),
        param_free=dev(param_free, torch.bool),
        any_fisheye=bool(np.any(np.asarray(fisheye, bool))),
    )


def initial_cam9(camera_array, cam_ids=None) -> np.ndarray:
    """Stack posed cameras into the (C,9) parameter block layout."""
    ids = cam_ids if cam_ids is not None else sorted(camera_array.posed_cameras.keys())
    rows = []
    for cid in ids:
        c = camera_array.cameras[cid]
        d = np.ravel(c.distortions) if c.distortions is not None else np.zeros(2)
        d = np.concatenate([d, np.zeros(max(0, 2 - len(d)))])
        rows.append(np.concatenate([c.rvec, c.translation, [1.0], d[:2]]))
    return np.asarray(rows)


# ---------------------------------------------------------------------------
# Normal-equation building blocks
# ---------------------------------------------------------------------------


def _masked_blocks_dense(problem: BADenseProblem, cam9, X, loss: str, f_scale: float):
    """Residuals r (C,2,P), IRLS weights w (C,2,P), blocks Jc (C,2,9,P) and
    Jp (C,2,3,P) with unobserved slots and frozen parameters zeroed, and the
    robust cost."""
    r, Jc, Jp = dense_observation_jacobian_blocks(
        cam9, X, problem.uv, problem.K0, problem.dist0, problem.fisheye, problem.inv_fx,
        problem.any_fisheye,
    )
    m = problem.obs_mask[:, None, :]  # (C,1,P)
    # where-select (not multiply): an unobserved slot may project
    # degenerately, and 0 * NaN would poison the reductions
    r = torch.where(m, r, 0.0)
    free = problem.param_free.to(r.dtype)
    Jc = torch.where(m[:, :, None, :], Jc, 0.0) * free[:, None, :, None]
    Jp = torch.where(m[:, :, None, :], Jp, 0.0)
    w_obs, cost = robust_weights_and_cost((r**2).reshape(-1), loss, f_scale)
    return r, w_obs.reshape(r.shape), Jc, Jp, cost


def _cost_only(problem: BADenseProblem, cam9, X, loss: str, f_scale: float):
    r = dense_observation_residuals(
        cam9, X, problem.uv, problem.K0, problem.dist0, problem.fisheye, problem.inv_fx,
        problem.any_fisheye,
    )
    r = torch.where(problem.obs_mask[:, None, :], r, 0.0)
    return robust_weights_and_cost((r**2).reshape(-1), loss, f_scale)[1]


def _gradient_and_diag_dense(w, r, Jc, Jp):
    """g = J^T W r as (g_c (C,9), g_p (P,3)) and the camera blocks d_c
    (C,9,9) of J^T W J: plain einsums over the dense grid, where the slot
    position is the index. The point blocks d_p are built only where a
    solver needs them (`_point_blocks`)."""
    wr = w * r
    g_c = torch.einsum("crip,crp->ci", Jc, wr)
    return g_c, (Jp * wr[:, :, None, :]).sum((0, 1)).T, _camera_blocks(Jc * w[:, :, None, :], Jc)


def _camera_blocks(U, Jc):
    """d_c (C,9,9) = sum over r and p of U[c,r,i,p] Jc[c,r,j,p], as one
    (18C, P) x (P, 18C) product of which only the diagonal camera blocks are
    kept. The per-camera batched product (C tiny outputs over a reduction of
    2P) runs on C thread blocks of the card and measured ~2.4 ms per LM
    iteration on the H100, the largest device cost of the iteration; the
    single product computes C times the needed values but fills the card."""
    C = U.shape[0]
    rows = C * 2 * N_CAM_PARAMS
    full = (U.reshape(rows, -1) @ Jc.reshape(rows, -1).T).view(C, 2, N_CAM_PARAMS, C, 2, N_CAM_PARAMS)
    cams = torch.arange(C, device=U.device)
    blocks = full[cams, :, :, cams]  # (C, 2, 9, 2, 9)
    return blocks[:, 0, :, 0] + blocks[:, 1, :, 1]


def _point_blocks(w, Jp):
    """Point blocks of J^T W J: (raw (P,3,3), pinned (P,3,3)). The pinned
    copy puts the identity on fully-unobserved points (their gradient is
    zero, so their update stays exactly zero)."""
    d_p = torch.einsum("crip,crjp->pij", Jp * w[:, :, None, :], Jp)
    pinned = torch.diagonal(d_p, dim1=1, dim2=2).sum(-1) == 0
    return d_p, d_p + pinned[:, None, None] * torch.eye(3, dtype=d_p.dtype, device=d_p.device)


def _diag(d):
    return torch.diagonal(d, dim1=-2, dim2=-1)


# ---------------------------------------------------------------------------
# Linear solvers for (H + lam * D) dx = -g
# ---------------------------------------------------------------------------


def _solve_dense(problem, w, Jc, Jp, g_c, g_p, d_c, lam):
    """Assemble the full damped normal system (dim 9C + 3P) and
    Cholesky-solve it. Exact; for calibration-scale problems."""
    C, P = problem.n_cameras, g_p.shape[0]
    nc = N_CAM_PARAMS * C
    dim = nc + 3 * P
    dt, dev = g_c.dtype, g_c.device
    U = Jc * w[:, :, None, :]
    Hpp, d_p = _point_blocks(w, Jp)
    H = torch.zeros((dim, dim), dtype=dt, device=dev)
    cams = torch.arange(C, device=dev)
    pts = torch.arange(P, device=dev)
    H[:nc, :nc].view(C, N_CAM_PARAMS, C, N_CAM_PARAMS)[cams, :, cams, :] = d_c
    # point blocks without the pinning identity: unobserved points get
    # only the damping term below
    H[nc:, nc:].view(P, 3, P, 3)[pts, :, pts, :] = Hpp
    Hcp = torch.einsum("crip,crkp->cipk", U, Jp).reshape(nc, 3 * P)
    H[:nc, nc:] = Hcp
    H[nc:, :nc] = Hcp.T
    D = torch.cat([torch.clamp(_diag(d_c), min=1e-12).reshape(-1), torch.clamp(_diag(d_p), min=1e-12).reshape(-1)])
    free_flat = torch.cat([problem.param_free.reshape(-1), torch.ones(3 * P, dtype=torch.bool, device=dev)])
    A = H + torch.diag(lam * D + torch.where(free_flat, 0.0, 1.0).to(dt))
    b = -torch.cat([g_c.reshape(-1), g_p.reshape(-1)])
    dx = torch.cholesky_solve(b[:, None], _cholesky(A))[:, 0]
    dx = torch.where(free_flat, dx, 0.0)
    return dx[:nc].reshape(C, N_CAM_PARAMS), dx[nc:].reshape(P, 3)


def _cholesky(A):
    """Cholesky factor of A, NaN where the factorization fails (as
    jax.scipy.linalg.cho_factor returns it): the step then comes out NaN,
    the cost test rejects it and the damping grows. cholesky_ex also spares
    the device->host check torch.linalg.cholesky makes."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.nan)


def _damped_A_cc(problem, d_c, lam):
    """Damped camera block A_cc = d_c + diag(lam * diag(d_c) + frozen-row
    regularization); one definition for every Schur path."""
    diag_c = torch.clamp(_diag(d_c), min=1e-12)
    return d_c + torch.diag_embed(lam * diag_c + torch.where(problem.param_free, 0.0, 1.0).to(d_c.dtype))


def _add_camera_blocks(S, problem, A_cc):
    """S (9C, 9C) with A_cc (C,9,9) added to its diagonal camera blocks."""
    C = problem.n_cameras
    cams = torch.arange(C, device=S.device)
    S4 = S.reshape(C, N_CAM_PARAMS, C, N_CAM_PARAMS).clone()
    S4[cams, :, cams, :] += A_cc
    return S4.reshape(C * N_CAM_PARAMS, C * N_CAM_PARAMS)


def _pminor_backsub(Hpp_inv_t, bp_corr_t):
    """dxp = Hpp^-1 bp_corr in point-minor (3, P) layout -> (P, 3)."""
    return sum(Hpp_inv_t[:, j] * bp_corr_t[j][None, :] for j in range(3)).T


def _solve_schur(problem, w, Jc, Jp, g_c, g_p, d_c, lam, fused: bool):
    """Schur-eliminated solve, exact for the damped reprojection system.

    fused: assemble S, its right-hand side and the inverse point blocks with
    the fused kernel (fused_schur.schur_s_rhs) instead of its plain version
    (fused_schur.schur_s_rhs_plain)."""
    C = problem.n_cameras
    free_c = problem.param_free.to(g_c.dtype)
    bp_t = (-g_p).T.contiguous()  # (3,P)
    assemble = schur_s_rhs if fused else schur_s_rhs_plain
    S_raw, rhs_raw, Hpp_inv_t = assemble(Jc, Jp, w, bp_t, lam)
    S = _add_camera_blocks(-S_raw, problem, _damped_A_cc(problem, d_c, lam))
    rhs_c = (-g_c).reshape(-1) - rhs_raw
    dxc = torch.cholesky_solve(rhs_c[:, None], _cholesky(S))[:, 0]
    dxc = dxc.reshape(C, N_CAM_PARAMS) * free_c
    # bp_corr = bp - G^T dxc, with G^T dxc recomputed from the blocks
    tmp = w * (Jc * dxc[:, None, :, None]).sum(2)
    gtd = (Jp * tmp[:, :, None, :]).sum((0, 1))  # (3,P)
    return dxc, _pminor_backsub(Hpp_inv_t, bp_t - gtd)


def _predicted_decrease(w, Jp, d_c, g_c, g_p, dxc, dxp, lam):
    """Damped-model predicted cost decrease for the LM gain ratio:
    0.5 * (lam * dx^T D dx - g^T dx) with D = diag(J^T W J) floored. The
    point diagonal is recomputed from the blocks; dropping its pinning and
    floor is exact (unobserved points have dxp == 0)."""
    diag_c = torch.clamp(_diag(d_c), min=1e-12)
    cam_term = torch.sum(dxc * diag_c * dxc)
    diag_pt = (Jp * Jp * w[:, :, None, :]).sum((0, 1))  # (3,P)
    pt_term = torch.sum(dxp.T**2 * diag_pt)
    return 0.5 * (lam * (cam_term + pt_term) - (torch.sum(g_c * dxc) + torch.sum(g_p * dxp)))


# ---------------------------------------------------------------------------
# The LM loop
# ---------------------------------------------------------------------------


@dataclass
class BAResult:
    cam9: np.ndarray  # (C,9), host
    X: torch.Tensor  # (P,3) optimized world points, on the problem's device
    cost_initial: float
    cost_final: float
    n_iterations: int
    converged: bool
    gradient_norm: float
    solver: str = "schur"  # the linear solver the loop ran: 'dense' | 'schur'
    fused_schur: bool = False  # whether the Schur solves went through schur_s_rhs


def _lm_run(problem, cam9, X, lb, ub, *, loss, f_scale, max_iter, ftol, xtol, gtol, solver_kind, init_lambda, fused):
    """The LM loop. Returns (cam9, X, cost0, cost, gnorm, iterations, done)."""
    dt, dev = cam9.dtype, cam9.device
    cost0 = _cost_only(problem, cam9, X, loss, f_scale)
    cost = cost0
    lam = torch.tensor(init_lambda, dtype=dt, device=dev)
    gnorm = torch.tensor(float("inf"), dtype=dt, device=dev)
    it, done = 0, False
    while it < max_iter and not done:
        r, w, Jc, Jp, _ = _masked_blocks_dense(problem, cam9, X, loss, f_scale)
        g_c, g_p, d_c = _gradient_and_diag_dense(w, r, Jc, Jp)
        gnorm = torch.maximum(torch.max(torch.abs(g_c * problem.param_free)), torch.max(torch.abs(g_p)))
        if solver_kind == "dense":
            dxc, dxp = _solve_dense(problem, w, Jc, Jp, g_c, g_p, d_c, lam)
        else:
            dxc, dxp = _solve_schur(problem, w, Jc, Jp, g_c, g_p, d_c, lam, fused)

        cam9_new, X_new = torch.clamp(cam9 + dxc, lb, ub), X + dxp
        cost_new = _cost_only(problem, cam9_new, X_new, loss, f_scale)

        # gain ratio vs the damped-model predicted decrease
        pred = _predicted_decrease(w, Jp, d_c, g_c, g_p, dxc, dxp, lam)
        rho = (cost - cost_new) / torch.clamp(pred, min=1e-30)
        accept = cost_new < cost
        lam = torch.where(accept, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0), lam * 4.0)
        lam = torch.clamp(lam, 1e-12, 1e10)

        cam9 = torch.where(accept, cam9_new, cam9)
        X = torch.where(accept, X_new, X)
        rel_dec = (cost - cost_new) / torch.clamp(cost, min=1e-30)
        # scipy-style termination: ftol (small accepted relative decrease),
        # xtol (small accepted step), gtol, or a stalled trust region
        x_norm = torch.sqrt(torch.sum(cam9**2) + torch.sum(X**2))
        dx_norm = torch.sqrt(torch.sum(dxc**2) + torch.sum(dxp**2))
        done_t = (
            (accept & (rel_dec < ftol))
            | (accept & (dx_norm < xtol * (x_norm + xtol)))
            | (gnorm < gtol)
            | (lam >= 1e9)
        )
        cost = torch.where(accept, cost_new, cost)
        it += 1
        done = bool(done_t)  # the one device->host read of the iteration
    return cam9, X, cost0, cost, gnorm, it, done


def lm_solve(problem: BADenseProblem, cam9_0, X0, config: BAConfig = BAConfig(), *, fused_schur: bool | None = None) -> BAResult:
    """Run Levenberg-Marquardt bundle adjustment on the problem's device.

    Args:
        problem: BADenseProblem (make_dense_problem).
        cam9_0:  (C,9) initial camera blocks [rvec, tvec, s, k1, k2].
        X0:      (P,3) initial world points (host array or tensor).
        config:  BAConfig.
        fused_schur: assemble the Schur system with the fused kernel. None
            (default) uses it whenever `fused_schur_available` says the
            problem qualifies (CUDA, float32, <= 16 cameras); True forces it
            (the wrapper raises on inputs it cannot take); False never.

    Returns BAResult; X stays on the device.
    """
    if not isinstance(problem, BADenseProblem):
        raise not_ported("Bundle adjustment on the sparse row layout", "item 16, sparse row and obs-minor layouts")
    dtype, device = problem.uv.dtype, problem.uv.device
    C = problem.n_cameras
    P = int(X0.shape[0])
    dim = N_CAM_PARAMS * C + 3 * P

    if config.solver != "auto":
        solver_kind = config.solver
    elif dim <= config.dense_cutoff:
        solver_kind = "dense"
    else:
        schur_bytes = 2 * C * P * N_CAM_PARAMS * 3 * torch.finfo(dtype).bits // 8
        solver_kind = "schur" if schur_bytes <= 1 << 30 else "schur_cg"
    if solver_kind in ("cg", "schur_cg"):
        raise not_ported(f"The {solver_kind!r} linear solver", "item 17, cg and schur_cg solvers")
    if solver_kind not in ("dense", "schur"):
        raise ValueError(f"Unknown solver {config.solver!r}")
    if fused_schur is None:
        fused_schur = fused_schur_available(problem, P, dtype)

    lb = np.full((C, N_CAM_PARAMS), -BIG)
    ub = np.full((C, N_CAM_PARAMS), BIG)
    lb[:, 6:] = INTRINSIC_LOWER
    ub[:, 6:] = INTRINSIC_UPPER
    on_dev = dict(dtype=dtype, device=device)
    cam9, X, cost0, cost, gnorm, it, done = _lm_run(
        problem,
        torch.as_tensor(np.asarray(cam9_0), **on_dev),
        torch.as_tensor(X0, **on_dev),
        torch.as_tensor(lb, **on_dev),
        torch.as_tensor(ub, **on_dev),
        loss=config.loss,
        f_scale=float(config.f_scale),
        max_iter=config.max_iter,
        ftol=config.ftol,
        xtol=config.xtol,
        gtol=config.gtol,
        solver_kind=solver_kind,
        init_lambda=config.init_lambda,
        fused=bool(fused_schur),
    )
    # one small readback for the camera blocks and scalars
    flat = torch.cat([cam9.reshape(-1), torch.stack([cost0, cost, gnorm])]).cpu().numpy()
    nc = N_CAM_PARAMS * C
    return BAResult(
        cam9=flat[:nc].reshape(C, N_CAM_PARAMS),
        X=X,
        cost_initial=float(flat[nc]),
        cost_final=float(flat[nc + 1]),
        n_iterations=it,
        converged=done,
        gradient_norm=float(flat[nc + 2]),
        solver=solver_kind,
        fused_schur=bool(fused_schur) and solver_kind == "schur",
    )


def bound_warnings(cam9, proximity: float = 0.01) -> list[str]:
    """Warn when free intrinsics sit within `proximity` of their bounds."""
    warnings = []
    names = ["f-scale", "k1", "k2"]
    for c in range(cam9.shape[0]):
        for j in range(3):
            v = cam9[c, 6 + j]
            lo, hi = INTRINSIC_LOWER[j], INTRINSIC_UPPER[j]
            span = hi - lo
            if v - lo < proximity * span or hi - v < proximity * span:
                warnings.append(
                    f"Camera index {c}: intrinsic {names[j]} = {v:.4f} is near its bound [{lo}, {hi}] — "
                    f"intrinsic calibration may be unreliable; consider dedicated intrinsic calibration."
                )
    return warnings
