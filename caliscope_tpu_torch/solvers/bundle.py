"""Bundle adjustment as Levenberg-Marquardt on three observation layouts.

Port of caliscope_tpu/solvers/bundle.py:

- Layouts. The dense (C, P) grid with the long point axis minor
  (`BADenseProblem`, `make_dense_problem`), for problems whose (point,
  camera) pairs are unique and whose grid is reasonably full; and the
  sparse observation rows (`BAProblem`, `make_problem`), stored sorted by
  (point, camera), which take any pattern — static markers seen from many
  frames, chained co-visibility. A sparse solve runs its per-observation
  tensors obs-minor (r (2,N), Jc (2,9,N)) or row-major (r (N,2), Jc
  (N,2,9)); `BAConfig.obs_minor` picks.
- Distance-constraint rows (board rigidity, static markers) on either
  layout: their blocks key world points only, and fold into the point
  gradient and diagonal, the matvec and the full system.
- Linear solvers: 'dense' (assemble the 9C + 3P system, Cholesky);
  'schur' (eliminate the points; with constraint rows the Schur solve is
  the preconditioner of a short CG on the full system); 'schur_cg'
  (matrix-free CG on the reduced camera system, reprojection-only) and 'cg'
  (block-Jacobi CG on the full system), which need no (C, P, 9, 3) coupling
  tensor and so take problems past the explicit Schur factors' 1 GiB.
- IRLS robust weights, gain-ratio damping and scipy-style termination with
  the same expressions as the JAX package.

Where the JAX package runs the loops as `lax.while_loop`s, this port runs
Python loops over device tensors. The LM loop reads one termination flag per
iteration. The CG loops run their body unconditionally, freeze the state
once the stopping test holds (as the while-loop would have stopped), and
read the flag once every CG_CHECK_EVERY iterations, so their iterates and
counts are the JAX package's. An LM iteration is split at those two reads
into pieces without a host read — `_lm_head` (blocks, gradient, the step as
far as its CG), `_pcg_chunk` (a chunk of CG iterations) and `_lm_tail` (the
step, the gain-ratio update, the termination test) — which the loop here
calls in turn and a baked solve replays as CUDA graphs.

Point reductions are segment sums over offsets computed once per solve
(`_Plan`): sparse rows are sorted by point, constraint slots are sorted once
by a stable argsort. Camera reductions are products with a one-hot matrix.
None of them uses atomics, so a solve gives the same bits on every run.

The dense reprojection-only Schur solve assembles S, its right-hand side and
the inverse point blocks with the fused kernel (solvers/fused_schur.py)
whenever the problem is one the kernel takes (`fused_schur=None`, the
default), or as the caller says (`fused_schur=True/False`). The kernel takes
neither constrained nor sparse problems: those use the explicit Schur
factors in plain tensor operations, and `fused_schur=True` raises there.

Sharding: `lm_solve(mesh=...)`, or the `BAConfig.shard` policy under an
initialised torch.distributed process group, solves a problem split over
the ranks (parallel/sharded.py): the dense layout's point axis or the sparse
layout's observation rows. Every rank runs this loop on its shard, and the
plan's mesh all-reduces each sum over the sharded axis (`_reduce`): camera
sums and the cost on both layouts, point sums on the sparse one, scalars
over points on the dense one. On the dense layout the fused kernel runs on
each rank's points, whose S and right-hand side add up over the ranks.

Baking the problem into the program (`BAConfig.bake_problem=True`):
solvers/baked.py runs those pieces as CUDA graphs captured once and cached on
the problem instance, as the JAX package caches its baked executable, with
the same answers as the loop here (the pieces themselves, eagerly, on the
CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from caliscope_tpu_torch.device import resolve_device, resolve_dtype
from caliscope_tpu_torch.ops.reprojection import (
    N_CAM_PARAMS,
    constraint_jacobian_blocks,
    constraint_residuals,
    dense_observation_jacobian_blocks,
    dense_observation_residuals,
    observation_blocks_obs_minor,
    observation_jacobian_blocks,
    observation_residuals,
    observation_residuals_obs_minor,
    robust_weights_and_cost,
)
from caliscope_tpu_torch.solvers.fused_schur import (
    fused_schur_available,
    hpp_inv_plain,
    inv3x3_pminor,
    schur_s_rhs,
    schur_s_rhs_plain,
)
from caliscope_tpu_torch.tracing import span

# Free-intrinsics bounds: s in [0.5, 2], k1 in [-1, 1], k2 in [-2, 2].
INTRINSIC_LOWER = np.array([0.5, -1.0, -2.0])
INTRINSIC_UPPER = np.array([2.0, 1.0, 2.0])
BIG = 1e20

# The CG loops read their stopping flag back to the host once every this
# many iterations (a frozen iterate costs one wasted matvec; a read costs a
# device->host round trip).
CG_CHECK_EVERY = 8

# Which sparse layout BAConfig.obs_minor='auto' takes on CUDA: the faster per
# LM iteration on the static-marker pipeline's problem, as chip_smoke.py
# measures both (row-major, 46.9 against 55.7 ms on an H100; PERF.md). The
# obs-minor layout exists for the TPU's (8, 128) tiles, which a GPU does not
# have. On the CPU 'auto' is row-major, as in the JAX package.
OBS_MINOR_ON_CUDA = False


@dataclass(frozen=True)
class BAConfig:
    """Solver configuration."""

    loss: str = "linear"  # 'linear' | 'soft_l1'
    f_scale: float = 1.0  # robust inlier scale, in normalized residual units
    max_iter: int = 200
    ftol: float = 1e-8
    xtol: float = 1e-10
    gtol: float = 1e-12
    solver: str = "auto"  # 'auto' | 'dense' | 'schur' | 'schur_cg' | 'cg'
    cg_tol: float = 1e-6
    cg_max_iter: int = 200
    init_lambda: float = 1e-4
    # 'auto' picks dense when 9C + 3P <= dense_cutoff
    dense_cutoff: int = 6000
    # sharding over an initialised torch.distributed process group:
    #   'auto'   — when the group has more than one rank and the problem has
    #              at least shard_min_obs observations
    #   'always' — whenever a group is initialised (one rank included)
    #   'never'  — single placement
    shard: str = "auto"
    shard_min_obs: int = 20_000
    # run the LM iteration as CUDA graphs captured once and cached on the
    # problem instance (solvers/baked.py); the same answers, eagerly on the CPU
    bake_problem: bool = False
    # sparse problems' per-observation layout: 'auto' | 'always' | 'never'
    obs_minor: str = "auto"


@dataclass
class BAProblem:
    """Bundle-adjustment problem in the sparse row layout, as device tensors.

    Rows are sorted by (pt_idx, cam_idx) (make_problem sorts them), so every
    point reduction is a segment sum over sorted keys. Padded rows carry
    obs_mask=False. Constraint arrays have Q rows (Q may be 0)."""

    cam_idx: torch.Tensor  # (N,) int64
    pt_idx: torch.Tensor  # (N,) int64
    uv: torch.Tensor  # (N,2) pixels
    obs_mask: torch.Tensor  # (N,) bool
    K0: torch.Tensor  # (C,3,3) initial intrinsics
    dist0: torch.Tensor  # (C,5) initial distortions
    fisheye: torch.Tensor  # (C,) bool
    inv_fx: torch.Tensor  # (C,) 1/fx_init residual scaling
    param_free: torch.Tensor  # (C,9) bool
    con_pa_idx: torch.Tensor  # (Q,4) int64
    con_pa_w: torch.Tensor  # (Q,4)
    con_pb_idx: torch.Tensor  # (Q,4) int64
    con_pb_w: torch.Tensor  # (Q,4)
    con_target: torch.Tensor  # (Q,)
    con_weight: torch.Tensor  # (Q,)
    any_fisheye: bool = True
    shard: Optional[object] = None  # this rank's rows of a sharded problem (parallel.sharded.Shard)

    @property
    def n_cameras(self) -> int:
        return self.K0.shape[0]

    @property
    def n_obs(self) -> int:
        return self.cam_idx.shape[0]

    @property
    def n_constraints(self) -> int:
        return self.con_target.shape[0]


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
    con_pa_idx: torch.Tensor  # (Q,4) int64
    con_pa_w: torch.Tensor  # (Q,4)
    con_pb_idx: torch.Tensor  # (Q,4) int64
    con_pb_w: torch.Tensor  # (Q,4)
    con_target: torch.Tensor  # (Q,)
    con_weight: torch.Tensor  # (Q,)
    any_fisheye: bool = True
    shard: Optional[object] = None  # this rank's points of a sharded problem (parallel.sharded.Shard)

    @property
    def n_cameras(self) -> int:
        return self.K0.shape[0]

    @property
    def n_points(self) -> int:
        return self.uv.shape[2]

    @property
    def n_obs(self) -> int:
        """Observation slots, the grid's size (as the JAX package counts)."""
        return self.uv.shape[0] * self.uv.shape[2]

    @property
    def n_constraints(self) -> int:
        return self.con_target.shape[0]


def _host_common(K0, fisheye, refine_intrinsics, fixed_cameras, constraints):
    """The layout-independent host arrays: free-parameter mask, 1/fx and the
    six constraint arrays (empty when there are none)."""
    C = np.asarray(K0).shape[0]
    param_free = np.zeros((C, N_CAM_PARAMS), bool)
    param_free[:, :6] = True
    if fixed_cameras is not None:
        param_free[np.asarray(fixed_cameras, bool), :6] = False
    if refine_intrinsics:
        param_free[:, 6:] = True
    if constraints is None:
        constraints = (np.zeros((0, 4)), np.zeros((0, 4)), np.zeros((0, 4)), np.zeros((0, 4)), np.zeros(0), np.zeros(0))
    pa_idx, pa_w, pb_idx, pb_w, target, weight = (np.asarray(a) for a in constraints)
    fx = np.asarray(K0, np.float64)[:, 0, 0]
    return dict(
        param_free=(param_free, torch.bool),
        inv_fx=(1.0 / fx, None),
        con_pa_idx=(pa_idx.astype(np.int64), torch.int64),
        con_pa_w=(pa_w, None),
        con_pb_idx=(pb_idx.astype(np.int64), torch.int64),
        con_pb_w=(pb_w, None),
        con_target=(target, None),
        con_weight=(weight, None),
    )


def _on_device(fields: dict, device, dtype) -> dict:
    """{name: (host array, tensor dtype or None for the float dtype)} ->
    {name: device tensor}."""
    return {
        k: torch.as_tensor(np.ascontiguousarray(a), device=device, dtype=dtype if dt is None else dt)
        for k, (a, dt) in fields.items()
    }


def make_problem(
    cam_idx,
    pt_idx,
    uv,
    K0,
    dist0,
    fisheye,
    refine_intrinsics: bool = False,
    fixed_cameras=None,
    constraints=None,
    obs_mask=None,
    dtype=None,
    device=None,
) -> BAProblem:
    """Build a BAProblem from host arrays on `device` (CUDA unless named).

    constraints: optional (pa_idx, pa_w, pb_idx, pb_w, target, weight).
    fixed_cameras: optional boolean (C,) — freeze those cameras' extrinsics.
    Rows are stored sorted by (pt_idx, cam_idx), the JAX package's
    np.lexsort order, so every point reduction sees sorted segment keys."""
    device = resolve_device(device)
    dtype = resolve_dtype(device, dtype)
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    N = len(cam_idx)
    obs_mask = np.ones(N, bool) if obs_mask is None else np.asarray(obs_mask, bool)
    order = np.lexsort((cam_idx, pt_idx))
    if not np.array_equal(order, np.arange(N)):
        cam_idx, pt_idx, uv, obs_mask = cam_idx[order], pt_idx[order], uv[order], obs_mask[order]
    fisheye = np.asarray(fisheye, bool)
    fields = dict(
        cam_idx=(cam_idx.astype(np.int64), torch.int64),
        pt_idx=(pt_idx.astype(np.int64), torch.int64),
        uv=(uv, None),
        obs_mask=(obs_mask, torch.bool),
        K0=(np.asarray(K0, np.float64), None),
        dist0=(np.asarray(dist0, np.float64), None),
        fisheye=(fisheye, torch.bool),
        **_host_common(K0, fisheye, refine_intrinsics, fixed_cameras, constraints),
    )
    return BAProblem(**_on_device(fields, device, dtype), any_fisheye=bool(fisheye.any()))


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
    fisheye = np.asarray(fisheye, bool)
    fields = dict(
        uv=(grid_uv.transpose(1, 2, 0), None),
        obs_mask=(grid_mask.T, torch.bool),
        K0=(np.asarray(K0, np.float64), None),
        dist0=(np.asarray(dist0, np.float64), None),
        fisheye=(fisheye, torch.bool),
        **_host_common(K0, fisheye, refine_intrinsics, fixed_cameras, constraints),
    )
    return BADenseProblem(**_on_device(fields, device, dtype), any_fisheye=bool(fisheye.any()))


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
# Reductions without atomics
# ---------------------------------------------------------------------------


@dataclass
class _Plan:
    """Index structure of one solve, built once on the problem's device.

    pt_offsets / pc_offsets: segment offsets of the sparse rows (sorted by
    point, then camera) per point and per (point, camera) key; cam_onehot:
    the sparse rows' cameras as a (C, N) one-hot; con_order / con_offsets:
    the constraint slots (Q*8, in slot order) sorted stably by point, and
    their offsets per point.

    On a sharded problem: mesh, and whether it shards the dense layout's
    points (this rank's from point_offset on; constraint slots of other
    ranks' points sort past the last offset, so they add nothing here) or
    the sparse layout's observation rows. rows_mesh / points_mesh: the mesh
    where it shards that axis, else None."""

    n_points: int
    pt_offsets: Optional[torch.Tensor] = None
    pc_offsets: Optional[torch.Tensor] = None
    cam_onehot: Optional[torch.Tensor] = None
    con_order: Optional[torch.Tensor] = None
    con_offsets: Optional[torch.Tensor] = None
    mesh: Optional[object] = None
    shards_points: bool = False
    point_offset: int = 0

    @property
    def rows_mesh(self):
        return None if self.shards_points else self.mesh

    @property
    def points_mesh(self):
        return self.mesh if self.shards_points else None


def _offsets(keys, n: int):
    counts = torch.bincount(keys, minlength=n)
    return torch.cat([torch.zeros(1, dtype=counts.dtype, device=counts.device), torch.cumsum(counts, 0)])


def _make_plan(problem, P: int, dtype) -> _Plan:
    """The plan of a solve over P points (this rank's, on a point-sharded
    dense problem)."""
    plan = _Plan(P)
    if problem.shard is not None:
        plan.mesh = problem.shard.mesh
        plan.shards_points = isinstance(problem, BADenseProblem)
        plan.point_offset = problem.shard.offset
    if isinstance(problem, BAProblem):
        C = problem.n_cameras
        plan.pt_offsets = _offsets(problem.pt_idx, P)
        plan.pc_offsets = _offsets(problem.pt_idx * C + problem.cam_idx, C * P)
        cams = torch.arange(C, device=problem.cam_idx.device)
        plan.cam_onehot = (problem.cam_idx[None, :] == cams[:, None]).to(dtype)
    if problem.n_constraints:
        slots = torch.cat([problem.con_pa_idx, problem.con_pb_idx], 1).reshape(-1)
        if plan.points_mesh is not None:  # other ranks' points -> segment P, dropped
            local = slots - plan.point_offset
            slots = torch.where((local >= 0) & (local < P), local, P)
        plan.con_order = torch.argsort(slots, stable=True)
        plan.con_offsets = _offsets(slots, P)[: P + 1]
    return plan


def _reduce(mesh, *tensors):
    """The tensors summed over the mesh's ranks in one all-reduce, or as
    they are without a mesh: one tensor for one, else a tuple."""
    out = tensors if mesh is None else mesh.sum(*tensors)
    return out[0] if len(tensors) == 1 else tuple(out)


def _at_slots(problem, plan: Optional[_Plan], v):
    """A point vector v (P,3) at the constraint slots, (Q,8,3): on a
    point-sharded problem each slot's owner contributes it and the others
    zero, summed over the ranks (exact: one term is nonzero)."""
    slots = torch.cat([problem.con_pa_idx, problem.con_pb_idx], 1)
    if plan is None or plan.points_mesh is None:
        return v[slots]
    local = slots - plan.point_offset
    owned = (local >= 0) & (local < v.shape[0])
    vals = torch.where(owned[..., None], v[torch.clamp(local, 0, v.shape[0] - 1)], 0.0)
    return plan.points_mesh.sum(vals)[0]


def _segment_sum(data, offsets):
    """Sum of the rows of `data` (sorted by segment) per segment."""
    return torch.segment_reduce(data, "sum", offsets=offsets, axis=0, unsafe=True)


def _con_scatter(plan: _Plan, vals):
    """(Q*8, k) values in constraint-slot order -> (P, k) sums per point
    (this rank's points on a point-sharded problem)."""
    return _segment_sum(vals[plan.con_order], plan.con_offsets)


def _by_camera(plan: _Plan, rows):
    """(k, N) per-row values -> (C, k) sums per camera."""
    return (rows @ plan.cam_onehot.T).T


# ---------------------------------------------------------------------------
# Residuals, blocks, gradient and diagonal
# ---------------------------------------------------------------------------


def _masked_blocks_dense(problem: BADenseProblem, cam9, X, loss: str, f_scale: float):
    """Residuals r (C,2,P), IRLS weights w (C,2,P), blocks Jc (C,2,9,P) and
    Jp (C,2,3,P) with unobserved slots and frozen parameters zeroed, and the
    robust cost of the observations."""
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


def _masked_blocks_rows(problem: BAProblem, cam9, X, loss: str, f_scale: float):
    """Row-major blocks: r (N,2), w (N,2), Jc (N,2,9), Jp (N,2,3), cost."""
    r, Jc, Jp = observation_jacobian_blocks(
        cam9, X, problem.cam_idx, problem.pt_idx, problem.uv,
        problem.K0, problem.dist0, problem.fisheye, problem.inv_fx, problem.any_fisheye,
    )
    m = problem.obs_mask[:, None]
    r = torch.where(m, r, 0.0)
    free = problem.param_free.to(r.dtype)[problem.cam_idx]  # (N,9)
    Jc = torch.where(m[..., None], Jc, 0.0) * free[:, None, :]
    Jp = torch.where(m[..., None], Jp, 0.0)
    w_obs, cost = robust_weights_and_cost((r**2).reshape(-1), loss, f_scale)
    return r, w_obs.reshape(r.shape), Jc, Jp, cost


def _masked_blocks_obs_minor(problem: BAProblem, cam9, X, loss: str, f_scale: float):
    """Obs-minor blocks: r (2,N), w (2,N), Jc (2,9,N), Jp (2,3,N), cost."""
    r, Jc, Jp = observation_blocks_obs_minor(
        cam9, X, problem.cam_idx, problem.pt_idx, problem.uv.T,
        problem.K0, problem.dist0, problem.fisheye, problem.inv_fx, problem.any_fisheye,
    )
    m = problem.obs_mask[None, :]
    r = torch.where(m, r, 0.0)
    free = problem.param_free.to(r.dtype)[problem.cam_idx].T  # (9,N)
    Jc = torch.where(m[:, None, :], Jc, 0.0) * free[None]
    Jp = torch.where(m[:, None, :], Jp, 0.0)
    w_obs, cost = robust_weights_and_cost((r**2).reshape(-1), loss, f_scale)
    return r, w_obs.reshape(r.shape), Jc, Jp, cost


def _constraint_args(problem, plan: Optional[_Plan], X):
    """(X_all, pa_idx, pb_idx) for the constraint ops: X and the problem's
    slots, or on a point-sharded problem the points at the slots gathered
    over the ranks (Q*8, 3) with the slots renumbered into them."""
    if plan is None or plan.points_mesh is None:
        return X, problem.con_pa_idx, problem.con_pb_idx
    Q = problem.n_constraints
    ids = torch.arange(Q * 8, device=X.device).reshape(Q, 8)
    return _at_slots(problem, plan, X).reshape(-1, 3), ids[:, :4], ids[:, 4:]


def _constraint_blocks(problem, X, plan: Optional[_Plan] = None):
    """(rq (Q,), qidx (Q,8), Jq (Q,8,3), cost) of the constraint rows, or
    Nones and 0 without any; replicated on every rank of a sharded problem.
    Constraints always use the linear loss (they are metric priors)."""
    if not problem.n_constraints:
        return None, None, None, 0.0
    X_all, pa_idx, pb_idx = _constraint_args(problem, plan, X)
    rq, _, Jq = constraint_jacobian_blocks(
        X_all, pa_idx, problem.con_pa_w, pb_idx, problem.con_pb_w, problem.con_target, problem.con_weight,
    )
    qidx = torch.cat([problem.con_pa_idx, problem.con_pb_idx], 1)
    return rq, qidx, Jq, 0.5 * torch.sum(rq**2)


def _blocks(problem, cam9, X, loss: str, f_scale: float, obs_minor: bool, plan: Optional[_Plan]):
    """Residuals, IRLS weights and Jacobian blocks in the problem's layout,
    the observations' robust cost (this rank's, on a sharded problem), and
    the constraint rows with their cost:
    (r, w, Jc, Jp, cost_obs, rq, qidx, Jq, cost_con)."""
    if isinstance(problem, BADenseProblem):
        blocks = _masked_blocks_dense(problem, cam9, X, loss, f_scale)
    elif obs_minor:
        blocks = _masked_blocks_obs_minor(problem, cam9, X, loss, f_scale)
    else:
        blocks = _masked_blocks_rows(problem, cam9, X, loss, f_scale)
    return (*blocks, *_constraint_blocks(problem, X, plan))


def _masked_blocks(problem, cam9, X, loss: str, f_scale: float, obs_minor: bool = False):
    """Residuals, IRLS weights, Jacobian blocks in the problem's layout,
    constraint rows and the total robust cost of an unsharded problem:
    (r, w, Jc, Jp, rq, qidx, Jq, cost)."""
    r, w, Jc, Jp, cost_obs, rq, qidx, Jq, cost_con = _blocks(problem, cam9, X, loss, f_scale, obs_minor, None)
    return r, w, Jc, Jp, rq, qidx, Jq, cost_obs + cost_con


def _cost_only(problem, cam9, X, loss: str, f_scale: float, obs_minor: bool = False, plan: Optional[_Plan] = None):
    """Total robust cost (over all ranks): observations plus constraint rows."""
    if isinstance(problem, BADenseProblem):
        r = dense_observation_residuals(
            cam9, X, problem.uv, problem.K0, problem.dist0, problem.fisheye, problem.inv_fx,
            problem.any_fisheye,
        )
        r = torch.where(problem.obs_mask[:, None, :], r, 0.0)
    elif obs_minor:
        r = observation_residuals_obs_minor(
            cam9, X, problem.cam_idx, problem.pt_idx, problem.uv.T,
            problem.K0, problem.dist0, problem.fisheye, problem.inv_fx, problem.any_fisheye,
        )
        r = torch.where(problem.obs_mask[None, :], r, 0.0)
    else:
        r = observation_residuals(
            cam9, X, problem.cam_idx, problem.pt_idx, problem.uv,
            problem.K0, problem.dist0, problem.fisheye, problem.inv_fx, problem.any_fisheye,
        )
        r = torch.where(problem.obs_mask[:, None], r, 0.0)
    cost = _reduce(plan and plan.mesh, robust_weights_and_cost((r**2).reshape(-1), loss, f_scale)[1])
    if problem.n_constraints:
        X_all, pa_idx, pb_idx = _constraint_args(problem, plan, X)
        rq = constraint_residuals(
            X_all, pa_idx, problem.con_pa_w, pb_idx, problem.con_pb_w, problem.con_target, problem.con_weight,
        )
        cost = cost + 0.5 * torch.sum(rq**2)
    return cost


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


def _pin(d_p, pminor: bool):
    """Put the identity on fully-unobserved point blocks (their gradient is
    zero, so their update stays exactly zero)."""
    if pminor:
        pinned = (d_p[0, 0] + d_p[1, 1] + d_p[2, 2]) == 0
        return d_p + pinned[None, None, :] * torch.eye(3, dtype=d_p.dtype, device=d_p.device)[:, :, None]
    pinned = torch.diagonal(d_p, dim1=1, dim2=2).sum(-1) == 0
    return d_p + pinned[:, None, None] * torch.eye(3, dtype=d_p.dtype, device=d_p.device)


def _point_blocks(w, Jp):
    """Point blocks of J^T W J from dense blocks: (raw (P,3,3), pinned
    (P,3,3))."""
    d_p = torch.einsum("crip,crjp->pij", Jp * w[:, :, None, :], Jp)
    return d_p, _pin(d_p, False)


def _diag(d):
    return torch.diagonal(d, dim1=-2, dim2=-1)


def _diag_pminor(d_p_t):
    return torch.stack([d_p_t[0, 0], d_p_t[1, 1], d_p_t[2, 2]])  # (3,P)


def _constraint_grad_diag(plan: _Plan, qidx, Jq, rq, g_p, d_p, pminor: bool):
    """Fold the constraint rows into the point gradient and diagonal blocks
    (d_p (P,3,3), or (3,3,P) with pminor), then pin unobserved points."""
    if Jq is not None:
        P = g_p.shape[0]
        g_p = g_p + _con_scatter(plan, (Jq * rq[:, None, None]).reshape(-1, 3))
        dq = _con_scatter(plan, (Jq[:, :, :, None] * Jq[:, :, None, :]).reshape(-1, 9))  # (P,9)
        d_p = d_p + (dq.T.reshape(3, 3, P) if pminor else dq.reshape(P, 3, 3))
    return g_p, _pin(d_p, pminor)


def _gradient_and_diag(problem, plan: _Plan, w, r, Jc, Jp, rq, qidx, Jq, obs_minor: bool = False):
    """g = J^T W r and the diagonal blocks of J^T W J, constraint rows
    folded in: (g_c (C,9), g_p (P,3), d_c (C,9,9), d_p). d_p is (P,3,3)
    pinned, or (3,3,P) on the obs-minor layout; None on a dense
    reprojection-only problem, whose solvers build it from the blocks.
    Sums over the sharded axis are completed over the ranks before the
    replicated constraint rows fold in."""
    P = plan.n_points
    if isinstance(problem, BADenseProblem):
        g_c, g_p, d_c = _gradient_and_diag_dense(w, r, Jc, Jp)
        g_c, d_c = _reduce(plan.mesh, g_c, d_c)
        if not problem.n_constraints:
            return g_c, g_p, d_c, None
        g_p, d_p = _constraint_grad_diag(plan, qidx, Jq, rq, g_p, _point_blocks(w, Jp)[0], False)
        return g_c, g_p, d_c, d_p
    C = problem.n_cameras
    wr = w * r
    if obs_minor:
        g_c = _by_camera(plan, Jc[0] * wr[0] + Jc[1] * wr[1])
        U0, U1 = Jc[0] * w[0], Jc[1] * w[1]
        outer = (U0[:, None, :] * Jc[0][None] + U1[:, None, :] * Jc[1][None]).reshape(N_CAM_PARAMS**2, -1)
        d_c = _by_camera(plan, outer).reshape(C, N_CAM_PARAMS, N_CAM_PARAMS)
        gp = Jp[0] * wr[0] + Jp[1] * wr[1]  # (3,N)
        dp = (Jp[0] * w[0])[:, None, :] * Jp[0][None] + (Jp[1] * w[1])[:, None, :] * Jp[1][None]  # (3,3,N)
        seg = _segment_sum(torch.cat([gp, dp.reshape(9, -1)]).T, plan.pt_offsets)  # (P,12)
        g_c, d_c, seg = _reduce(plan.mesh, g_c, d_c, seg)
        g_p, d_p = _constraint_grad_diag(plan, qidx, Jq, rq, seg[:, :3], seg[:, 3:].T.reshape(3, 3, P), True)
        return g_c, g_p, d_c, d_p
    g_c = _by_camera(plan, (Jc * wr[..., None]).sum(1).T)
    U = Jc * w[..., None]
    UB = (U[:, :, :, None] * Jc[:, :, None, :]).sum(1).reshape(-1, N_CAM_PARAMS**2)
    d_c = _by_camera(plan, UB.T).reshape(C, N_CAM_PARAMS, N_CAM_PARAMS)
    Up = Jp * w[..., None]
    payload = torch.cat([(Jp * wr[..., None]).sum(1), (Up[:, :, :, None] * Jp[:, :, None, :]).sum(1).reshape(-1, 9)], 1)
    seg = _segment_sum(payload, plan.pt_offsets)  # (P,12)
    g_c, d_c, seg = _reduce(plan.mesh, g_c, d_c, seg)
    g_p, d_p = _constraint_grad_diag(plan, qidx, Jq, rq, seg[:, :3], seg[:, 3:].reshape(P, 3, 3), False)
    return g_c, g_p, d_c, d_p


def _hessian_matvec(problem, plan: _Plan, w, Jc, Jp, qidx, Jq, vc, vp, obs_minor: bool = False):
    """(H v) for H = J^T W J (constraint rows included), matrix-free from
    the blocks: (out_c (C,9), out_p (P,3)), over all ranks."""
    if isinstance(problem, BADenseProblem):
        Jv = (Jc * vc[:, None, :, None]).sum(2) + (Jp * vp.T[None, None]).sum(2)  # (C,2,P)
        wJv = w * Jv
        out_c = _reduce(plan.mesh, (Jc * wJv[:, :, None, :]).sum((1, 3)))
        out_p = (Jp * wJv[:, :, None, :]).sum((0, 1)).T
    elif obs_minor:
        ci, pi = problem.cam_idx, problem.pt_idx
        vcg, vpg = vc[ci].T, vp[pi].T  # (9,N), (3,N)
        wJv = w * ((Jc * vcg[None]).sum(1) + (Jp * vpg[None]).sum(1))  # (2,N)
        out_c = _by_camera(plan, Jc[0] * wJv[0] + Jc[1] * wJv[1])
        out_p = _segment_sum((Jp[0] * wJv[0] + Jp[1] * wJv[1]).T, plan.pt_offsets)
    else:
        ci, pi = problem.cam_idx, problem.pt_idx
        wJv = w * ((Jc * vc[ci][:, None, :]).sum(-1) + (Jp * vp[pi][:, None, :]).sum(-1))  # (N,2)
        out_c = _by_camera(plan, (Jc * wJv[..., None]).sum(1).T)
        out_p = _segment_sum((Jp * wJv[..., None]).sum(1), plan.pt_offsets)
    if not isinstance(problem, BADenseProblem):
        out_c, out_p = _reduce(plan.mesh, out_c, out_p)
    if Jq is not None:
        zq = (Jq * _at_slots(problem, plan, vp)).sum((1, 2))
        out_p = out_p + _con_scatter(plan, (Jq * zq[:, None, None]).reshape(-1, 3))
    return out_c, out_p


# ---------------------------------------------------------------------------
# Linear solvers for (H + lam * D) dx = -g
# ---------------------------------------------------------------------------


def _cholesky(A):
    """Cholesky factor of A, NaN where the factorization fails (as
    jax.scipy.linalg.cho_factor returns it): the step then comes out NaN,
    the cost test rejects it and the damping grows. cholesky_ex also spares
    the device->host check torch.linalg.cholesky makes."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.nan)


def _inv(A):
    """Batched inverse without the device->host error check."""
    return torch.linalg.inv_ex(A)[0]


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / det) of (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11, c12, c13 = e * i - f * h, c * h - b * i, b * f - c * e
    c21, c22, c23 = f * g - d * i, a * i - c * g, c * d - a * f
    c31, c32, c33 = d * h - e * g, b * g - a * h, a * e - b * d
    inv_det = 1.0 / (a * c11 + b * c21 + c * c31)
    rows = torch.stack(
        [torch.stack([c11, c12, c13], -1), torch.stack([c21, c22, c23], -1), torch.stack([c31, c32, c33], -1)], -2
    )
    return rows * inv_det[..., None, None]


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


def _damped_point_inverse(d_p, lam, pminor: bool):
    """Inverse of the damped point blocks d_p + lam * diag(d_p) + 1e-12 I
    (diagonal floored at 1e-12): (3,3,P) from a (3,3,P) d_p with pminor,
    else (P,3,3)."""
    if pminor:
        eye = torch.eye(3, dtype=d_p.dtype, device=d_p.device)[:, :, None]
        diag = torch.clamp(_diag_pminor(d_p), min=1e-12)
        return inv3x3_pminor(d_p + lam * diag[:, None, :] * eye + 1e-12 * eye)
    eye = torch.eye(3, dtype=d_p.dtype, device=d_p.device)
    return _inv3x3(d_p + torch.diag_embed(lam * torch.clamp(_diag(d_p), min=1e-12)) + 1e-12 * eye)


def _point_diag(problem, w, Jp, d_p, obs_minor: bool):
    """diag(d_p) floored at 1e-12, as (P,3)."""
    if d_p is None:
        d_p = _point_blocks(w, Jp)[1]
    if obs_minor and not isinstance(problem, BADenseProblem):
        return torch.clamp(_diag_pminor(d_p), min=1e-12).T
    return torch.clamp(_diag(d_p), min=1e-12)


def _solve_dense(problem, plan: _Plan, w, Jc, Jp, qidx, Jq, g_c, g_p, d_c, d_p, lam, obs_minor: bool = False):
    """Assemble the full damped normal system (dim 9C + 3P) and
    Cholesky-solve it. Exact; for calibration-scale problems."""
    C, P = problem.n_cameras, g_p.shape[0]
    nc = N_CAM_PARAMS * C
    dim = nc + 3 * P
    dt, dev = g_c.dtype, g_c.device
    H = torch.zeros((dim, dim), dtype=dt, device=dev)
    if isinstance(problem, BADenseProblem):
        U = Jc * w[:, :, None, :]
        Hpp, d_p_obs = _point_blocks(w, Jp)
        if d_p is None:
            d_p = d_p_obs
        cams = torch.arange(C, device=dev)
        pts = torch.arange(P, device=dev)
        H[:nc, :nc].view(C, N_CAM_PARAMS, C, N_CAM_PARAMS)[cams, :, cams, :] = d_c
        # point blocks without the pinning identity: unobserved points get
        # only the damping term below
        H[nc:, nc:].view(P, 3, P, 3)[pts, :, pts, :] = Hpp
        Hcp = torch.einsum("crip,crkp->cipk", U, Jp).reshape(nc, 3 * P)
        H[:nc, nc:] = Hcp
        H[nc:, :nc] = Hcp.T
    else:
        if obs_minor:  # small problems only: back to the row layout
            w, Jc, Jp, d_p = w.T, Jc.permute(2, 0, 1), Jp.permute(2, 0, 1), d_p.permute(2, 0, 1)
        ci = problem.cam_idx[:, None] * N_CAM_PARAMS + torch.arange(N_CAM_PARAMS, device=dev)  # (N,9)
        pi = nc + problem.pt_idx[:, None] * 3 + torch.arange(3, device=dev)  # (N,3)
        U = Jc * w[..., None]
        Hcc = (U[:, :, :, None] * Jc[:, :, None, :]).sum(1)  # (N,9,9)
        Hpp = ((Jp * w[..., None])[:, :, :, None] * Jp[:, :, None, :]).sum(1)  # (N,3,3)
        Hcp = (U[:, :, :, None] * Jp[:, :, None, :]).sum(1)  # (N,9,3)
        for (a, b), blk in (((ci, ci), Hcc), ((pi, pi), Hpp), ((ci, pi), Hcp), ((pi, ci), Hcp.transpose(1, 2))):
            H.index_put_((a[:, :, None].expand_as(blk), b[:, None, :].expand_as(blk)), blk, accumulate=True)
        H = _reduce(plan.rows_mesh, H)
    if Jq is not None:
        qi = (nc + qidx[:, :, None] * 3 + torch.arange(3, device=dev)).reshape(-1, 24)  # (Q,24)
        Jqf = Jq.reshape(-1, 24)
        Hqq = Jqf[:, :, None] * Jqf[:, None, :]
        H.index_put_((qi[:, :, None].expand_as(Hqq), qi[:, None, :].expand_as(Hqq)), Hqq, accumulate=True)
    D = torch.cat([torch.clamp(_diag(d_c), min=1e-12).reshape(-1), torch.clamp(_diag(d_p), min=1e-12).reshape(-1)])
    free_flat = torch.cat([problem.param_free.reshape(-1), torch.ones(3 * P, dtype=torch.bool, device=dev)])
    A = H + torch.diag(lam * D + torch.where(free_flat, 0.0, 1.0).to(dt))
    b = -torch.cat([g_c.reshape(-1), g_p.reshape(-1)])
    dx = torch.cholesky_solve(b[:, None], _cholesky(A))[:, 0]
    dx = torch.where(free_flat, dx, 0.0)
    return dx[:nc].reshape(C, N_CAM_PARAMS), dx[nc:].reshape(P, 3)


def _schur_factors(problem, plan: _Plan, w, Jc, Jp, d_c, d_p, lam, obs_minor: bool = False):
    """The explicit damped Schur factors: (Cholesky factor of S, G, Y,
    Hpp_inv, free_c, pminor, points_mesh). S = A_cc - G Hpp^-1 G^T over
    cameras (9C x 9C); G the camera-point coupling and Y = G Hpp^-1. Dense
    and obs-minor problems carry G, Y point-minor (C,9,3,P) and Hpp_inv
    (3,3,P); the row-major layout (C,P,9,3) and (P,3,3). d_p carries the
    constraint folds where there are constraint rows. On a point-sharded
    problem G, Y and Hpp_inv are this rank's points' and S is summed over
    the ranks; on a row-sharded one G is summed over the ranks first."""
    C, P = problem.n_cameras, plan.n_points
    dt = d_c.dtype
    n_cp = C * N_CAM_PARAMS
    free_c = problem.param_free.to(dt)
    A_cc = _damped_A_cc(problem, d_c, lam)
    if isinstance(problem, BADenseProblem) or obs_minor:
        if isinstance(problem, BADenseProblem):
            G = torch.einsum("crip,crkp->cikp", Jc * w[:, :, None, :], Jp)  # (C,9,3,P)
            Hpp_inv = hpp_inv_plain(Jp, w, lam) if d_p is None else _damped_point_inverse(d_p.permute(1, 2, 0), lam, True)
        else:
            # 27 coupling rows per observation, ONE segment sum keyed
            # (point, camera) in the rows' sorted order
            g_rows = ((Jc[0] * w[0])[:, None, :] * Jp[0][None] + (Jc[1] * w[1])[:, None, :] * Jp[1][None])
            Gseg = _segment_sum(g_rows.reshape(N_CAM_PARAMS * 3, -1).T, plan.pc_offsets)  # (P*C,27)
            Gseg = _reduce(plan.rows_mesh, Gseg)
            G = Gseg.reshape(P, C, N_CAM_PARAMS, 3).permute(1, 2, 3, 0)  # (C,9,3,P)
            Hpp_inv = _damped_point_inverse(d_p, lam, True)
        Y = torch.stack([sum(G[:, :, j, :] * Hpp_inv[j, k][None, None, :] for j in range(3)) for k in range(3)], 2)
        S = -_reduce(plan.points_mesh, Y.reshape(n_cp, -1) @ G.reshape(n_cp, -1).T)
        return _cholesky(_add_camera_blocks(S, problem, A_cc)), G, Y, Hpp_inv, free_c, True, plan.points_mesh
    Hpp_inv = _damped_point_inverse(d_p, lam, False)  # (P,3,3)
    W = ((Jc * w[..., None])[:, :, :, None] * Jp[:, :, None, :]).sum(1)  # (N,9,3)
    Gseg = _reduce(plan.rows_mesh, _segment_sum(W.reshape(-1, N_CAM_PARAMS * 3), plan.pc_offsets))  # (P*C,27)
    G = Gseg.reshape(P, C, N_CAM_PARAMS, 3).permute(1, 0, 2, 3)  # (C,P,9,3)
    Y = (G[..., :, :, None] * Hpp_inv[None, :, None, :, :]).sum(-2)  # (C,P,9,3)
    S = -(Y.permute(0, 2, 1, 3).reshape(n_cp, -1) @ G.permute(0, 2, 1, 3).reshape(n_cp, -1).T)
    return _cholesky(_add_camera_blocks(S, problem, A_cc)), G, Y, Hpp_inv, free_c, False, None


def _schur_apply(factors, bc, bp):
    """Solve the damped reprojection normal system for right-hand sides
    (bc (C,9), bp (P,3)) given the Schur factors."""
    L, G, Y, Hpp_inv, free_c, pminor, points_mesh = factors
    C = bc.shape[0]
    n_cp = C * N_CAM_PARAMS
    if pminor:
        bp_t = bp.T  # (3,P)
        rhs_c = bc.reshape(-1) - _reduce(points_mesh, sum(Y[:, :, k, :].reshape(n_cp, -1) @ bp_t[k] for k in range(3)))
        dxc = torch.cholesky_solve(rhs_c[:, None], L)[:, 0].reshape(C, N_CAM_PARAMS) * free_c
        bp_corr = bp_t - torch.stack([dxc.reshape(-1) @ G[:, :, k, :].reshape(n_cp, -1) for k in range(3)])
        return dxc, _pminor_backsub(Hpp_inv, bp_corr)
    rhs_c = bc - (Y * bp[None, :, None, :]).sum((1, 3))
    dxc = torch.cholesky_solve(rhs_c.reshape(-1, 1), L)[:, 0].reshape(C, N_CAM_PARAMS) * free_c
    bp_corr = bp - (G * dxc[:, None, :, None]).sum((0, 2))
    return dxc, (Hpp_inv * bp_corr[:, None, :]).sum(-1)


class _CGState(NamedTuple):
    """A PCG run's state: iterate, residual and direction (tuples of
    tensors), r.z, the stopping threshold tol^2 b.b, and the iterations
    taken (device scalars)."""

    x: tuple
    r: tuple
    p: tuple
    rz: torch.Tensor
    thresh: torch.Tensor
    it: torch.Tensor


@dataclass
class _CGSystem:
    """A linear solve that ends in a PCG: the operator, the preconditioner,
    the right-hand side, the mesh over whose ranks the points' part of a dot
    product is summed (None: not sharded, or a camera-only system), and
    `finish`, which maps the CG's x to (dxc, dxp)."""

    A_mv: Callable
    M_inv: Callable
    b: tuple
    points_mesh: Optional[object]
    finish: Callable


def _cg_dot(a, b, points_mesh):
    if points_mesh is None:
        return sum(torch.sum(x * y) for x, y in zip(a, b))
    return torch.sum(a[0] * b[0]) + points_mesh.sum(torch.sum(a[1] * b[1]))[0]


def _pcg_start(M_inv, b, tol: float, points_mesh=None) -> _CGState:
    """The state of a PCG from x = 0."""
    z = M_inv(b)
    return _CGState(
        x=tuple(torch.zeros_like(t) for t in b), r=b, p=z, rz=_cg_dot(b, z, points_mesh),
        thresh=(tol**2) * _cg_dot(b, b, points_mesh), it=torch.zeros((), dtype=torch.int64, device=b[0].device),
    )


def _pcg_chunk(A_mv, M_inv, state: _CGState, n: int, points_mesh=None):
    """n PCG iterations, each of which leaves the state as it was once the
    stopping test r.r <= thresh holds (as the while-loop would have
    stopped). Returns (state, whether the test still fails: a device bool)."""
    x, r, p, rz, thresh, it = state
    for _ in range(n):
        active = _cg_dot(r, r, points_mesh) > thresh
        Ap = A_mv(p)
        alpha = rz / torch.clamp(_cg_dot(p, Ap, points_mesh), min=1e-30)
        x_new = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r_new = tuple(ri - alpha * ai for ri, ai in zip(r, Ap))
        z = M_inv(r_new)
        rz_new = _cg_dot(r_new, z, points_mesh)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p_new = tuple(zi + beta * pi for zi, pi in zip(z, p))
        keep = lambda new, old: tuple(torch.where(active, a, o) for a, o in zip(new, old))  # noqa: E731
        x, r, p = keep(x_new, x), keep(r_new, r), keep(p_new, p)
        rz = torch.where(active, rz_new, rz)
        it = it + active.to(it.dtype)
    return _CGState(x, r, p, rz, thresh, it), _cg_dot(r, r, points_mesh) > thresh


def _cg_chunks(max_iter: int):
    """The chunk lengths of a PCG of at most max_iter iterations, as it
    reads its stopping flag: CG_CHECK_EVERY each, the last one shorter."""
    return [min(CG_CHECK_EVERY, max_iter - n) for n in range(0, max_iter, CG_CHECK_EVERY)]


def _pcg(A_mv, M_inv, b, tol: float, max_iter: int, points_mesh=None):
    """Preconditioned CG from x = 0 on tuples of tensors, as the JAX
    package's while-loops run it: stop once it == max_iter or
    r.r <= tol^2 b.b. The body runs in chunks of CG_CHECK_EVERY (a frozen
    iteration leaves the state as it was, so the result is the
    while-loop's), and the stopping flag is read after each. Returns (x,
    iterations as a device scalar). With points_mesh, the tuples are
    (cameras, this rank's points) and the points' part of each dot product
    is summed over the ranks."""
    state = _pcg_start(M_inv, b, tol, points_mesh)
    for n in _cg_chunks(max_iter):
        state, running = _pcg_chunk(A_mv, M_inv, state, n, points_mesh)
        with span("ba.read"):
            running = bool(running)  # the one device->host read of a chunk
        if not running:
            break
    return state.x, state.it


def _finish_cg(solved, tol, max_iter):
    """(dxc, dxp, CG iterations or None) of a solve that a setup function
    took as far as its CG: run the CG where there is one."""
    if not isinstance(solved, _CGSystem):
        return (*solved, None)
    x, it = _pcg(solved.A_mv, solved.M_inv, solved.b, tol, max_iter, solved.points_mesh)
    return (*solved.finish(x), it)


def _solve_schur(problem, plan: _Plan, w, Jc, Jp, qidx, Jq, g_c, g_p, d_c, d_p, lam, cg_tol, cg_max_iter, fused: bool = False, obs_minor: bool = False):
    """Schur-eliminated solve: exact for the damped reprojection system;
    with constraint rows present the Schur solve becomes the preconditioner
    of a short CG on the full system (constraints couple points to points,
    breaking the block-diagonal Hpp). Returns (dxc, dxp, CG iterations or
    None).

    fused: on a dense reprojection-only problem, assemble S, its right-hand
    side and the inverse point blocks with the fused kernel
    (fused_schur.schur_s_rhs) instead of its plain version."""
    setup = _schur_setup(problem, plan, w, Jc, Jp, qidx, Jq, g_c, g_p, d_c, d_p, lam, fused, obs_minor)
    return _finish_cg(setup, cg_tol, cg_max_iter)


def _schur_setup(problem, plan: _Plan, w, Jc, Jp, qidx, Jq, g_c, g_p, d_c, d_p, lam, fused: bool, obs_minor: bool):
    """_solve_schur up to its CG: (dxc, dxp) without constraint rows, else
    the CG on the full system (_CGSystem)."""
    if isinstance(problem, BADenseProblem) and not problem.n_constraints:
        C = problem.n_cameras
        free_c = problem.param_free.to(g_c.dtype)
        bp_t = (-g_p).T.contiguous()  # (3,P)
        assemble = schur_s_rhs if fused else schur_s_rhs_plain
        S_raw, rhs_raw, Hpp_inv_t = assemble(Jc, Jp, w, bp_t, lam)
        S_raw, rhs_raw = _reduce(plan.mesh, S_raw, rhs_raw)  # sums over points
        S = _add_camera_blocks(-S_raw, problem, _damped_A_cc(problem, d_c, lam))
        rhs_c = (-g_c).reshape(-1) - rhs_raw
        dxc = torch.cholesky_solve(rhs_c[:, None], _cholesky(S))[:, 0]
        dxc = dxc.reshape(C, N_CAM_PARAMS) * free_c
        # bp_corr = bp - G^T dxc, with G^T dxc recomputed from the blocks
        tmp = w * (Jc * dxc[:, None, :, None]).sum(2)
        gtd = (Jp * tmp[:, :, None, :]).sum((0, 1))  # (3,P)
        return dxc, _pminor_backsub(Hpp_inv_t, bp_t - gtd)
    factors = _schur_factors(problem, plan, w, Jc, Jp, d_c, d_p, lam, obs_minor)
    if not problem.n_constraints:
        return _schur_apply(factors, -g_c, -g_p)
    free_c = factors[4]
    diag_c = torch.clamp(_diag(d_c), min=1e-12)
    diag_p = _point_diag(problem, w, Jp, d_p, obs_minor)

    def A_mv(v):
        hc, hp = _hessian_matvec(problem, plan, w, Jc, Jp, qidx, Jq, v[0], v[1], obs_minor)
        return hc + lam * diag_c * v[0] + (1.0 - free_c) * v[0], hp + lam * diag_p * v[1]

    return _CGSystem(A_mv, lambda r: _schur_apply(factors, *r), (-g_c, -g_p), plan.points_mesh,
                     lambda x: (x[0] * free_c, x[1]))


def _solve_schur_cg(problem, plan: _Plan, w, Jc, Jp, g_c, g_p, d_c, d_p, lam, tol, max_iter, obs_minor: bool = False):
    """Implicit (matrix-free) Schur-complement CG on the reduced camera
    system S dxc = b, S = A - G Hpp^-1 G^T, each S-product two passes over
    the observations: the coupling tensor G is never built, so this solver
    has no C*P memory ceiling. Reprojection-only. Returns (dxc, dxp, CG
    iterations)."""
    return _finish_cg(_schur_cg_setup(problem, plan, w, Jc, Jp, g_c, g_p, d_c, d_p, lam, obs_minor), tol, max_iter)


def _schur_cg_setup(problem, plan: _Plan, w, Jc, Jp, g_c, g_p, d_c, d_p, lam, obs_minor: bool) -> _CGSystem:
    """_solve_schur_cg up to its CG (a camera-only system)."""
    free_c = problem.param_free.to(g_c.dtype)
    A_cc = _damped_A_cc(problem, d_c, lam)
    A_inv = _inv(A_cc)  # (C,9,9) exact block preconditioner
    if isinstance(problem, BADenseProblem):
        # point-minor blocks: Jc (C,2,9,P), Jp (C,2,3,P); Hpp^-1 (3,3,P)
        Hpp_inv_t = hpp_inv_plain(Jp, w, lam)

        def Hpp_inv_apply(vp):
            return _pminor_backsub(Hpp_inv_t, vp.T)

        def G_T(vc):  # (C,9) -> (P,3)
            t = w * (Jc * vc[:, None, :, None]).sum(2)
            return (Jp * t[:, :, None, :]).sum((0, 1)).T

        def G(vp):  # (P,3) -> (C,9)
            a = w * (Jp * vp.T[None, None]).sum(2)
            return (Jc * a[:, :, None, :]).sum((1, 3))

    elif obs_minor:
        Hpp_inv_t = _damped_point_inverse(d_p, lam, True)
        ci, pi = problem.cam_idx, problem.pt_idx

        def Hpp_inv_apply(vp):
            return _pminor_backsub(Hpp_inv_t, vp.T)

        def G_T(vc):
            t = w * (Jc * vc[ci].T[None]).sum(1)  # (2,N)
            return _segment_sum((Jp[0] * t[0] + Jp[1] * t[1]).T, plan.pt_offsets)

        def G(vp):
            a = w * (Jp * vp[pi].T[None]).sum(1)
            return _by_camera(plan, Jc[0] * a[0] + Jc[1] * a[1])

    else:
        Hpp_inv = _damped_point_inverse(d_p, lam, False)
        ci, pi = problem.cam_idx, problem.pt_idx

        def Hpp_inv_apply(vp):
            return (Hpp_inv * vp[:, None, :]).sum(-1)

        def G_T(vc):
            t = w * (Jc * vc[ci][:, None, :]).sum(-1)  # (N,2)
            return _segment_sum((Jp * t[..., None]).sum(1), plan.pt_offsets)

        def G(vp):
            a = w * (Jp * vp[pi][:, None, :]).sum(-1)
            return _by_camera(plan, (Jc * a[..., None]).sum(1).T)

    if plan.mesh is not None:
        G_local, G_T_local = G, G_T

        def G(vp):  # a sum over points or rows: over the ranks
            return _reduce(plan.mesh, G_local(vp))

        def G_T(vc):  # a sum over rows on the sparse layout
            return _reduce(plan.rows_mesh, G_T_local(vc))

    def S_mv(v):
        (vc,) = v
        Sp = (A_cc * vc[:, None, :]).sum(-1) - G(Hpp_inv_apply(G_T(vc)))
        return (Sp * free_c + (1.0 - free_c) * vc,)

    def finish(x):
        dxc = x[0] * free_c
        return dxc, Hpp_inv_apply(-g_p - G_T(dxc))

    b = (-g_c + G(Hpp_inv_apply(g_p))) * free_c
    return _CGSystem(S_mv, lambda r: ((A_inv * r[0][:, None, :]).sum(-1),), (b,), None, finish)


def _solve_cg(problem, plan: _Plan, w, Jc, Jp, qidx, Jq, g_c, g_p, d_c, d_p, lam, tol, max_iter, obs_minor: bool = False):
    """Block-Jacobi preconditioned CG on the full damped normal equations,
    matrix-free (each matvec one pass over the observations and constraint
    rows). Returns (dxc, dxp, CG iterations)."""
    return _finish_cg(_cg_setup(problem, plan, w, Jc, Jp, qidx, Jq, g_c, g_p, d_c, d_p, lam, obs_minor), tol, max_iter)


def _cg_setup(problem, plan: _Plan, w, Jc, Jp, qidx, Jq, g_c, g_p, d_c, d_p, lam, obs_minor: bool) -> _CGSystem:
    """_solve_cg up to its CG."""
    free_c = problem.param_free.to(g_c.dtype)
    diag_c = torch.clamp(_diag(d_c), min=1e-12)
    M_c_inv = _inv(d_c + torch.diag_embed(lam * diag_c + torch.where(problem.param_free, 0.0, 1.0).to(d_c.dtype)))
    if d_p is None:
        d_p = _point_blocks(w, Jp)[1]
    pminor = obs_minor and not isinstance(problem, BADenseProblem)
    M_p_inv = _damped_point_inverse(d_p, lam, pminor)
    diag_p = _point_diag(problem, w, Jp, d_p, obs_minor)

    def M_p_apply(vp):
        return _pminor_backsub(M_p_inv, vp.T) if pminor else (M_p_inv * vp[:, None, :]).sum(-1)

    def A_mv(v):
        hc, hp = _hessian_matvec(problem, plan, w, Jc, Jp, qidx, Jq, v[0], v[1], obs_minor)
        # frozen camera params act as identity rows (rhs is zero there)
        return hc + lam * diag_c * v[0] + (1.0 - free_c) * v[0], hp + lam * diag_p * v[1]

    def M_inv(r):
        return (M_c_inv * r[0][:, None, :]).sum(-1), M_p_apply(r[1])

    return _CGSystem(A_mv, M_inv, (-g_c, -g_p), plan.points_mesh, lambda x: (x[0] * free_c, x[1]))


def _predicted_decrease(problem, w, Jp, d_c, d_p, g_c, g_p, dxc, dxp, lam, obs_minor: bool = False, plan: Optional[_Plan] = None):
    """Damped-model predicted cost decrease for the LM gain ratio:
    0.5 * (lam * dx^T D dx - g^T dx) with D = diag(J^T W J) floored. A dense
    reprojection-only problem recomputes the point diagonal from the blocks;
    dropping its pinning and floor is exact there (unobserved points have
    dxp == 0). On a point-sharded problem the points' terms are summed over
    the ranks."""
    diag_c = torch.clamp(_diag(d_c), min=1e-12)
    cam_term = torch.sum(dxc * diag_c * dxc)
    if isinstance(problem, BADenseProblem) and not problem.n_constraints:
        diag_pt = (Jp * Jp * w[:, :, None, :]).sum((0, 1))  # (3,P)
        pt_term = torch.sum(dxp.T**2 * diag_pt)
    else:
        pt_term = torch.sum(dxp * _point_diag(problem, w, Jp, d_p, obs_minor) * dxp)
    pt_term, gp_dxp = _reduce(plan and plan.points_mesh, pt_term, torch.sum(g_p * dxp))
    return 0.5 * (lam * (cam_term + pt_term) - (torch.sum(g_c * dxc) + gp_dxp))


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
    solver: str = "schur"  # the linear solver the loop ran
    fused_schur: bool = False  # whether the Schur solves went through schur_s_rhs
    obs_minor: bool = False  # whether a sparse problem ran obs-minor
    cg_iterations: tuple[int, ...] = ()  # CG iterations per LM iteration, where the solver ran a CG
    n_devices: int = 1  # ranks the problem was sharded over


def _lm_head(problem, plan, cam9, X, lam, *, loss, f_scale, solver_kind, fused, obs_minor):
    """The head of one LM iteration: blocks, gradient and the damped step as
    far as its CG. Returns (the step (dxc, dxp), or the _CGSystem that ends
    it; gnorm; the model's terms (w, Jp, d_c, d_p, g_c, g_p); this rank's
    observation cost; the constraint rows' cost)."""
    r, w, Jc, Jp, cost_obs, rq, qidx, Jq, cost_con = _blocks(problem, cam9, X, loss, f_scale, obs_minor, plan)
    g_c, g_p, d_c, d_p = _gradient_and_diag(problem, plan, w, r, Jc, Jp, rq, qidx, Jq, obs_minor)
    gmax_p = torch.max(torch.abs(g_p))
    if plan.points_mesh is not None:
        gmax_p = plan.points_mesh.max(gmax_p)
    gnorm = torch.maximum(torch.max(torch.abs(g_c * problem.param_free)), gmax_p)
    if solver_kind == "dense":
        solved = _solve_dense(problem, plan, w, Jc, Jp, qidx, Jq, g_c, g_p, d_c, d_p, lam, obs_minor)
    elif solver_kind == "schur":
        solved = _schur_setup(problem, plan, w, Jc, Jp, qidx, Jq, g_c, g_p, d_c, d_p, lam, fused, obs_minor)
    elif solver_kind == "schur_cg":
        solved = _schur_cg_setup(problem, plan, w, Jc, Jp, g_c, g_p, d_c, d_p, lam, obs_minor)
    else:
        solved = _cg_setup(problem, plan, w, Jc, Jp, qidx, Jq, g_c, g_p, d_c, d_p, lam, obs_minor)
    return solved, gnorm, (w, Jp, d_c, d_p, g_c, g_p), cost_obs, cost_con


def _step(problem, plan, cam9, X, lam, *, loss, f_scale, solver_kind, cg_tol, cg_max_iter, fused, obs_minor):
    """Blocks, gradient and damped step of one LM iteration: (dxc, dxp,
    gnorm, CG iterations or None, the model's terms (w, Jp, d_c, d_p, g_c,
    g_p), this rank's observation cost, the constraint rows' cost)."""
    solved, gnorm, model, cost_obs, cost_con = _lm_head(
        problem, plan, cam9, X, lam, loss=loss, f_scale=f_scale, solver_kind=solver_kind, fused=fused, obs_minor=obs_minor,
    )
    dxc, dxp, cg_it = _finish_cg(solved, cg_tol, cg_max_iter)
    return dxc, dxp, gnorm, cg_it, model, cost_obs, cost_con


def _lm_update(problem, plan, cam9, X, lam, cost, dxc, dxp, cam9_new, X_new, model, *, loss, f_scale, obs_minor):
    """The trial point's cost, the accept test and the gain-ratio damping
    update of one LM iteration: (cam9', X', lam', cost_new, accepted)."""
    cost_new = _cost_only(problem, cam9_new, X_new, loss, f_scale, obs_minor, plan)
    pred = _predicted_decrease(problem, *model, dxc, dxp, lam, obs_minor, plan)
    rho = (cost - cost_new) / torch.clamp(pred, min=1e-30)
    accept = cost_new < cost
    lam = torch.where(accept, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0), lam * 4.0)
    cam9, X = torch.where(accept, cam9_new, cam9), torch.where(accept, X_new, X)
    return cam9, X, torch.clamp(lam, 1e-12, 1e10), cost_new, accept


def _lm_tail(problem, plan, cam9, X, lam, cost, gnorm, dxc, dxp, model, lb, ub, *, loss, f_scale, ftol, xtol, gtol, obs_minor):
    """The tail of one LM iteration, from its step: the bounded trial point,
    the gain-ratio update and the termination test. Returns (cam9', X',
    lam', cost', done as a device bool)."""
    cam9, X, lam, cost_new, accept = _lm_update(
        problem, plan, cam9, X, lam, cost, dxc, dxp, torch.clamp(cam9 + dxc, lb, ub), X + dxp, model,
        loss=loss, f_scale=f_scale, obs_minor=obs_minor,
    )
    rel_dec = (cost - cost_new) / torch.clamp(cost, min=1e-30)
    # scipy-style termination: ftol (small accepted relative decrease),
    # xtol (small accepted step), gtol, or a stalled trust region
    sum_X2, sum_dxp2 = _reduce(plan.points_mesh, torch.sum(X**2), torch.sum(dxp**2))
    x_norm = torch.sqrt(torch.sum(cam9**2) + sum_X2)
    dx_norm = torch.sqrt(torch.sum(dxc**2) + sum_dxp2)
    done = (
        (accept & (rel_dec < ftol))
        | (accept & (dx_norm < xtol * (x_norm + xtol)))
        | (gnorm < gtol)
        | (lam >= 1e9)
    )
    return cam9, X, lam, torch.where(accept, cost_new, cost), done


def _lm_run(problem, plan, cam9, X, lb, ub, *, loss, f_scale, max_iter, ftol, xtol, gtol, solver_kind, cg_tol, cg_max_iter, init_lambda, fused, obs_minor):
    """The LM loop. Returns (cam9, X, cost0, cost, gnorm, iterations, done,
    CG iteration counts as device scalars). Every value the loop branches on
    is replicated or summed over the ranks, so on a sharded problem all
    ranks stop together."""
    dt, dev = cam9.dtype, cam9.device
    cost0 = _cost_only(problem, cam9, X, loss, f_scale, obs_minor, plan)
    cost = cost0
    lam = torch.tensor(init_lambda, dtype=dt, device=dev)
    gnorm = torch.tensor(float("inf"), dtype=dt, device=dev)
    it, done, cg_its = 0, False, []
    while it < max_iter and not done:
        with span("ba.lm_iter"):
            dxc, dxp, gnorm, cg_it, model, _, _ = _step(
                problem, plan, cam9, X, lam, loss=loss, f_scale=f_scale, solver_kind=solver_kind, cg_tol=cg_tol,
                cg_max_iter=cg_max_iter, fused=fused, obs_minor=obs_minor,
            )
            if cg_it is not None:
                cg_its.append(cg_it)
            cam9, X, lam, cost, done_t = _lm_tail(
                problem, plan, cam9, X, lam, cost, gnorm, dxc, dxp, model, lb, ub,
                loss=loss, f_scale=f_scale, ftol=ftol, xtol=xtol, gtol=gtol, obs_minor=obs_minor,
            )
            it += 1
            with span("ba.read"):
                done = bool(done_t)  # the one device->host read of the iteration
    return cam9, X, cost0, cost, gnorm, it, done, cg_its


def _use_obs_minor(problem, policy: str = "auto") -> bool:
    """Whether a solve of `problem` takes the obs-minor sparse layout (never
    a sharded one, as in the JAX package under a mesh)."""
    if policy not in ("auto", "always", "never"):
        raise ValueError(f"Unknown obs_minor policy {policy!r}")
    if isinstance(problem, BADenseProblem) or problem.shard is not None or policy == "never":
        return False
    if policy == "always":
        return True
    return problem.uv.device.type == "cuda" and OBS_MINOR_ON_CUDA


def _solver_kind(problem, config: BAConfig, C: int, P: int) -> str:
    """The linear solver a solve runs: the config's, or under 'auto' 'schur'
    on a sharded problem, else dense for small systems, the explicit Schur
    factors while their two (C, P, 9, 3) tensors fit in 1 GiB, past it the
    implicit Schur CG (or the full CG on a constrained problem, whose point
    coupling the implicit Schur elimination cannot take)."""
    if config.solver != "auto":
        kind = config.solver
    elif problem.shard is not None:
        kind = "schur"
    elif N_CAM_PARAMS * C + 3 * P <= config.dense_cutoff:
        kind = "dense"
    else:
        schur_bytes = 2 * C * P * N_CAM_PARAMS * 3 * torch.finfo(problem.uv.dtype).bits // 8
        if schur_bytes <= 1 << 30:
            kind = "schur"
        else:
            kind = "schur_cg" if not problem.n_constraints else "cg"
    if kind not in ("dense", "schur", "schur_cg", "cg"):
        raise ValueError(f"Unknown solver {config.solver!r}")
    if kind == "dense" and isinstance(problem, BADenseProblem) and problem.shard is not None:
        raise ValueError("solver='dense' assembles every point's rows on one rank; a point-sharded problem takes 'schur', 'schur_cg' or 'cg'")
    return kind


def _sharded(problem, config: BAConfig, mesh, cam9_0, X0):
    """The problem a solve runs: as given when it is already sharded, else
    this rank's shard over `mesh`, or over the default process group as
    config.shard says ('auto': a group of more than one rank and at least
    shard_min_obs observations; 'always': any initialised group), or the
    problem itself on a single placement. Sharding checks that every rank
    holds the same problem, cam9_0 and X0, and raises ValueError if not."""
    from caliscope_tpu_torch.parallel.sharded import Mesh, make_obs_mesh, shard_problem

    if config.shard not in ("auto", "always", "never"):
        raise ValueError(f"Unknown shard policy {config.shard!r}")
    if problem.shard is not None:
        if mesh is not None and mesh is not problem.shard.mesh:
            raise ValueError("the problem is sharded over another mesh")
        return problem
    if mesh is None:
        import torch.distributed as dist

        if config.shard == "never" or not (dist.is_available() and dist.is_initialized()):
            return problem
        if config.shard == "auto" and (dist.get_world_size() < 2 or problem.n_obs < config.shard_min_obs):
            return problem
        mesh = make_obs_mesh(problem.uv.device)
    elif not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a caliscope_tpu_torch.parallel.Mesh, not {type(mesh).__name__}")
    return shard_problem(problem, mesh, cam9_0, X0)


def _local_points(problem, X):
    """Points (P,3) of the whole problem -> those of this rank's block on a
    point-sharded problem (the padding points at the centroid, as the JAX
    package pads X0), else X itself."""
    shard = problem.shard
    if shard is None or not isinstance(problem, BADenseProblem):
        return X
    extra = shard.n_global - X.shape[0]
    if extra > 0:
        X = torch.cat([X, X.mean(0, keepdim=True).expand(extra, 3)])
    return X[shard.offset : shard.offset + shard.length]


def _all_points(problem, X, P: int):
    """This rank's points -> the first P points of the whole problem."""
    if problem.shard is not None and isinstance(problem, BADenseProblem):
        X = problem.shard.mesh.gather_rows(X)
    return X[:P] if X.shape[0] != P else X


def _bounds(C: int, on_dev: dict):
    """(lb, ub) of the (C,9) camera blocks: the free intrinsics' bounds,
    extrinsics unbounded."""
    lb = np.full((C, N_CAM_PARAMS), -BIG)
    ub = np.full((C, N_CAM_PARAMS), BIG)
    lb[:, 6:] = INTRINSIC_LOWER
    ub[:, 6:] = INTRINSIC_UPPER
    return torch.as_tensor(lb, **on_dev), torch.as_tensor(ub, **on_dev)


def lm_iteration(problem, cam9, X, lam, *, loss: str = "linear", f_scale: float = 1.0, use_dense: bool = False, solver: str = "schur", cg_tol: float = 1e-6, cg_max_iter: int = 200):
    """One full Levenberg-Marquardt iteration (assembly + linear solve +
    gain-ratio damping update) on the problem's device, without bounds or
    termination tests: the unit a sharded problem's ranks run together
    (parallel/sharded.py). X is every point of the problem (P,3).

    Returns (cam9', X', lam', cost', accepted) as tensors."""
    if solver == "schur_cg" and not use_dense and problem.n_constraints:
        raise ValueError(
            "solver='schur_cg' is reprojection-only (constraints couple points "
            "and break the block-diagonal Hpp elimination); use 'schur' or 'cg'."
        )
    dtype, device = problem.uv.dtype, problem.uv.device
    on_dev = dict(dtype=dtype, device=device)
    cam9, lam = torch.as_tensor(cam9, **on_dev), torch.as_tensor(lam, **on_dev)
    X_all = torch.as_tensor(X, **on_dev)
    X = _local_points(problem, X_all)
    kind = _solver_kind(problem, BAConfig(solver="dense" if use_dense else solver), problem.n_cameras, X.shape[0])
    plan = _make_plan(problem, X.shape[0], dtype)
    obs_minor = _use_obs_minor(problem)
    fused = isinstance(problem, BADenseProblem) and fused_schur_available(problem, X.shape[0], dtype)
    dxc, dxp, _gnorm, _it, model, cost_obs, cost_con = _step(
        problem, plan, cam9, X, lam, loss=loss, f_scale=f_scale, solver_kind=kind, cg_tol=cg_tol,
        cg_max_iter=cg_max_iter, fused=fused, obs_minor=obs_minor,
    )
    cost = _reduce(plan.mesh, cost_obs) + cost_con
    cam9, X, lam, cost_new, accept = _lm_update(
        problem, plan, cam9, X, lam, cost, dxc, dxp, cam9 + dxc, X + dxp, model,
        loss=loss, f_scale=f_scale, obs_minor=obs_minor,
    )
    return cam9, _all_points(problem, X, X_all.shape[0]), lam, torch.minimum(cost, cost_new), accept


def lm_solve(problem, cam9_0, X0, config: BAConfig = BAConfig(), mesh=None, *, fused_schur: bool | None = None) -> BAResult:
    """Run Levenberg-Marquardt bundle adjustment on the problem's device.

    Args:
        problem: BAProblem (make_problem) or BADenseProblem (make_dense_problem),
            whole or already sharded (parallel.shard_problem).
        cam9_0:  (C,9) initial camera blocks [rvec, tvec, s, k1, k2].
        X0:      (P,3) initial world points, all of them (host array or tensor).
        config:  BAConfig.
        mesh:    a parallel.Mesh to shard the problem over (every rank of its
            process group calls lm_solve with the same arguments); None
            leaves it to config.shard.
        fused_schur: assemble the Schur system with the fused kernel. None
            (default) uses it whenever the problem qualifies (dense layout,
            no constraint rows, CUDA, float32, <= 16 cameras); True forces
            it (raising on a constrained or sparse problem, and where the
            wrapper cannot take the inputs); False never. On a sharded
            problem it runs on each rank's points.

    Returns BAResult; X stays on the device, whole on every rank.
    """
    if not isinstance(problem, (BAProblem, BADenseProblem)):
        raise TypeError(f"lm_solve takes a BAProblem or a BADenseProblem, not {type(problem).__name__}")
    if config.solver == "schur_cg" and problem.n_constraints:
        raise ValueError(
            "solver='schur_cg' is reprojection-only (constraints couple points "
            "and break the block-diagonal Hpp elimination); use 'schur', 'cg', "
            "or 'auto'."
        )
    if fused_schur and (not isinstance(problem, BADenseProblem) or problem.n_constraints):
        raise ValueError(
            "fused_schur=True: the fused Schur kernel takes dense reprojection-only "
            "problems; this one is sparse or has constraint rows"
        )
    given = problem
    with span("ba.setup"):
        problem = _sharded(problem, config, mesh, cam9_0, X0)
        dtype, device = problem.uv.dtype, problem.uv.device
        on_dev = dict(dtype=dtype, device=device)
        C = problem.n_cameras
        X_all = torch.as_tensor(X0, **on_dev)
        X = _local_points(problem, X_all)
        P = int(X.shape[0])
        if fused_schur is None:
            fused_schur = isinstance(problem, BADenseProblem) and fused_schur_available(problem, P, dtype)
        opts = dict(
            loss=config.loss,
            f_scale=float(config.f_scale),
            max_iter=config.max_iter,
            ftol=config.ftol,
            xtol=config.xtol,
            gtol=config.gtol,
            solver_kind=_solver_kind(problem, config, C, P),
            cg_tol=config.cg_tol,
            cg_max_iter=config.cg_max_iter,
            init_lambda=config.init_lambda,
            fused=bool(fused_schur),
            obs_minor=_use_obs_minor(problem, config.obs_minor),
        )
        cam9_0 = torch.as_tensor(np.asarray(cam9_0), **on_dev)
        if config.bake_problem:
            from caliscope_tpu_torch.solvers.baked import baked_runner

            runner = baked_runner(given, problem, P, opts)
            problem = runner.problem
            run = partial(runner.solve, cam9_0, X)
        else:
            lb, ub = _bounds(C, on_dev)
            run = partial(_lm_run, problem, _make_plan(problem, P, dtype), cam9_0, X, lb, ub, **opts)
    cam9, X, cost0, cost, gnorm, it, done, cg_its = run()
    with span("ba.finish"):
        # one small readback for the camera blocks, scalars and CG counts
        tail = [cost0, cost, gnorm] + [c.to(dtype) for c in cg_its]
        flat = torch.cat([cam9.reshape(-1), torch.stack(tail)]).cpu().numpy()
        nc = N_CAM_PARAMS * C
        return BAResult(
            cam9=flat[:nc].reshape(C, N_CAM_PARAMS),
            X=_all_points(problem, X, X_all.shape[0]),
            cost_initial=float(flat[nc]),
            cost_final=float(flat[nc + 1]),
            n_iterations=it,
            converged=done,
            gradient_norm=float(flat[nc + 2]),
            solver=opts["solver_kind"],
            fused_schur=opts["fused"] and opts["solver_kind"] == "schur",
            obs_minor=opts["obs_minor"],
            cg_iterations=tuple(int(c) for c in flat[nc + 3 :]),
            n_devices=problem.shard.mesh.size if problem.shard is not None else 1,
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
