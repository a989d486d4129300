"""What decides `correct` in the calibrate cells: the program's answer
against the plain float64 reference (ba.py) and the scene's own data.

The reference runs the pipeline's last three stages itself, from the
scene's observations and its truth perturbed from the seed, never from
anything the program made: the robust stage (soft-L1 at 1 px) on every
observation, the filter's rule (the worst `percentile` % of each camera's
errors dropped) on its own robust optimum, and the final stage on what
that keeps. The program's answer, handed over as plain arrays (`Answer`),
is judged by:
- `pipe_kept_diff`: observations the program kept and the reference did
  not, or the other way round;
- `pipe_cam_gap_mm`, `pipe_rot_gap_deg`, `pipe_pt_gap_mm`: its cameras and
  points against the reference's final optimum, after the motion (a
  similarity without constraints, a rigid motion with them) that best
  maps one rig onto the other;
- `cam_gap_mm`, `rot_gap_deg`, `pt_gap_mm`: the same against the
  reference's optimum of the final stage on the observations the program
  kept, so that a gap in the final stage shows apart from the filter's;
- `rmse_gap`: the RMSE the program reports against the RMSE of its own
  cameras and points over its kept observations, worked out in float64;
- `kept_diff`: observations whose fate differs from the filter's rule
  applied in float64 to the program's own state before its filter, plus
  points the program holds that no kept observation sees or the other way
  round: the filter stage checked by itself;
- `rigidity_gap_mm` (with constraints): the board rigidity RMSE the
  program reports against the reference's at its optimum.

Imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from typing import Optional

import numpy as np

from portbench.reference import ba


@dataclass
class Answer:
    """One calibration as plain arrays. Cameras in id order: R (C,3,3), t
    (C,3) world->camera. Points: keys (P,3) [sync, object, corner], xyz
    (P,3). Observations: keys (M,4) [sync, camera, object, corner], uv
    (M,2). `before_filter` is the same for the state the filter was given
    (its observations need no uv)."""

    R: np.ndarray
    t: np.ndarray
    point_keys: np.ndarray
    xyz: np.ndarray
    obs_keys: np.ndarray
    uv: np.ndarray
    rmse_px: float
    rigidity_mm: Optional[float] = None
    before_filter: Optional["Answer"] = None


def truss_edges(corners, spacing):
    """The board truss of `corners` (N,3): neighbour edges along rows and
    columns, both diagonals of every cell, and the six braces among the four
    extreme corners (upstream's board constraints)."""
    xk = np.round(corners[:, 0] / spacing).astype(np.int64)
    yk = np.round(corners[:, 1] / spacing).astype(np.int64)
    coord = {(int(x), int(y)): i for i, (x, y) in enumerate(zip(xk, yk))}
    edges = []
    for (x, y), i in coord.items():
        for nb in ((x + 1, y), (x, y + 1)):
            if nb in coord:
                edges.append((i, coord[nb]))
    for (x, y), i in coord.items():
        right, up, diag = coord.get((x + 1, y)), coord.get((x, y + 1)), coord.get((x + 1, y + 1))
        if right is not None and up is not None and diag is not None:
            edges += [(i, diag), (right, up)]
    ext = [coord[(xk.min(), yk.min())], coord[(xk.min(), yk.max())], coord[(xk.max(), yk.min())], coord[(xk.max(), yk.max())]]
    edges += list(combinations(ext, 2))
    return np.array(sorted(edges), np.int64)


def _key(a, widths):
    """Row keys of the integer columns of `a` as one int64 each."""
    out = np.zeros(len(a), np.int64)
    for col, w in zip(np.asarray(a, np.int64).T, widths):
        out = out * w + col
    return out


def _errors(ans, scene, obs_keys, uv):
    """Euclidean reprojection errors (px) of observations through ans's
    cameras and points, float64; NaN where ans has no such point."""
    n_kp = len(scene["local"])
    pk = _key(ans.point_keys[:, [0, 2]], (1 << 20, n_kp))
    order = np.argsort(pk)
    want = _key(obs_keys[:, [0, 3]], (1 << 20, n_kp))
    pos = np.clip(np.searchsorted(pk[order], want), 0, len(pk) - 1)
    found = pk[order][pos] == want
    X = ans.xyz[order][pos]
    c = obs_keys[:, 1]
    uv_hat = ba.project(X, ans.R[c], ans.t[c], scene["K"][c], scene["dist"][c])
    err = np.linalg.norm(uv_hat - uv, axis=1)
    err[~found] = np.nan
    return err


def truss_rows(point_keys, edges, corners):
    """(a, b, target) of the truss rows whose two corners are points (rows
    of point_keys [sync, object, corner]) of one sync index and object."""
    n_kp = len(corners)
    key = _key(point_keys, (1 << 20, 1 << 8, n_kp))
    order = np.argsort(key)
    groups = np.unique(point_keys[:, :2], axis=0)
    base = ((groups[:, 0] * (1 << 8) + groups[:, 1]) * n_kp)[:, None]

    def find(k):
        pos = np.clip(np.searchsorted(key[order], k), 0, len(key) - 1)
        return order[pos], key[order][pos] == k

    ia, oka = find((base + edges[None, :, 0]).ravel())
    ib, okb = find((base + edges[None, :, 1]).ravel())
    target = np.tile(np.linalg.norm(corners[edges[:, 0]] - corners[edges[:, 1]], axis=1), len(groups))
    ok = oka & okb
    return ia[ok], ib[ok], target[ok]


def rigidity_rmse_mm(point_keys, xyz, edges, corners):
    """RMS (mm) of |Xa - Xb| - d over the truss rows whose two corners are
    points of the same sync index and object."""
    a, b, target = truss_rows(point_keys, edges, corners)
    if not len(a):
        return float("nan")
    return 1e3 * float(np.sqrt(np.mean((np.linalg.norm(xyz[a] - xyz[b], axis=1) - target) ** 2)))


def reference_solution(scene, obs_keys, uv, constrained, sigma_m, seed, round_to=None, loss="linear"):
    """The reference's optimum of a stage's problem on the observations
    (obs_keys, uv): the final stage's (`loss` "linear") or the robust
    stage's ("soft_l1" at 1 px). Returns (R, t, point_keys, xyz, cost, iterations)."""
    n_kp = len(scene["local"])
    pkey = _key(obs_keys[:, [0, 2, 3]], (1 << 20, 1 << 8, n_kp))
    _ukeys, pt = np.unique(pkey, return_inverse=True)
    first = np.unique(pt, return_index=True)[1]
    point_keys = obs_keys[first][:, [0, 2, 3]]
    group = point_keys[:, 0]
    f_median = float(np.median(scene["K"][:, 0, 0]))
    cons = None
    if constrained:
        a, b, target = truss_rows(point_keys, truss_edges(scene["charuco"], scene["spacing"]), scene["charuco"])
        cons = (a, b, target, np.full(len(a), (1.0 / f_median) / sigma_m))
    prob = ba.Problem(obs_keys[:, 1], pt, uv, scene["K"], scene["dist"], group, cons, round_to=round_to, loss=loss,
                      f_scale=1.0 / f_median)
    rng = np.random.default_rng([seed, 7])
    R0 = ba.rodrigues(rng.normal(scale=0.002, size=(len(scene["R"]), 3))) @ scene["R"]
    t0 = scene["t"] + rng.normal(scale=0.005, size=scene["t"].shape)
    X0 = scene["world"][point_keys[:, 0], point_keys[:, 2]] + rng.normal(scale=0.002, size=(len(point_keys), 3))
    R, t, X, cost, it = prob.solve(R0, t0, X0)
    return R, t, point_keys, X, cost, it


def kept_by_rule(bf, scene, percentile, round_to=None):
    """Keys (int64) of the observations the filter's rule keeps from the
    state `bf` (an Answer) before it: per camera, errors up to the
    (100 - percentile)-th percentile (numpy's linear interpolation), errors
    in float64 (or rounded)."""
    err = _errors(bf, scene, bf.obs_keys, bf.uv)
    if round_to == "bfloat16":
        err = ba.bf16(err)
    keep = np.zeros(len(err), bool)
    matched = ~np.isnan(err)
    for c in np.unique(bf.obs_keys[:, 1]):
        sel = matched & (bf.obs_keys[:, 1] == c)
        if sel.any():
            keep[sel] = err[sel] <= np.percentile(err[sel], 100 - percentile)
    return _obs_key(bf.obs_keys[keep], scene)


def _obs_key(keys, scene):
    return _key(keys, (1 << 20, 1 << 8, 1 << 8, len(scene["local"])))


def scene_observations(scene):
    """(keys (M,4) [sync, camera, object, corner], uv (M,2)): every
    observation of the scene, the pipeline's input."""
    keys = np.stack([scene["sync"], scene["cam"], np.zeros_like(scene["sync"]), scene["kp"]], 1).astype(np.int64)
    return keys, np.asarray(scene["uv"], float)


def reference_pipeline(scene, constrained, sigma_m, percentile, seed, round_to=None):
    """The reference's own robust stage, filter and final stage from the
    scene's observations, as an Answer whose `before_filter` is its robust
    optimum (its reports in the same precision as its arithmetic)."""
    keys, uv = scene_observations(scene)
    R, t, pkeys, X, _cost, _it = reference_solution(scene, keys, uv, constrained, sigma_m, seed, round_to, "soft_l1")
    robust = Answer(R, t, pkeys, X, keys, uv, float("nan"))
    keep = np.isin(_obs_key(keys, scene), kept_by_rule(robust, scene, percentile, round_to))
    obs, uv = keys[keep], uv[keep]
    R, t, pkeys, X, _cost, _it = reference_solution(scene, obs, uv, constrained, sigma_m, seed, round_to)
    q = ba.bf16 if round_to == "bfloat16" else (lambda x: x)
    c = obs[:, 1]
    n_kp = len(scene["local"])
    pos = np.searchsorted(_key(pkeys, (1 << 20, 1 << 8, n_kp)), _key(obs[:, [0, 2, 3]], (1 << 20, 1 << 8, n_kp)))
    err = q(np.linalg.norm(q(ba.project(X[pos], R[c], t[c], scene["K"][c], scene["dist"][c])) - q(uv), axis=1))
    rig = None
    if constrained:
        rig = rigidity_rmse_mm(pkeys, q(X), truss_edges(scene["charuco"], scene["spacing"]), scene["charuco"])
    return Answer(R, t, pkeys, X, obs, uv, float(np.sqrt(np.mean(err**2))), rig, robust)


def _gaps(ans, R, t, pkeys, X, scene, constrained):
    """(camera centre gap, rotation gap, RMS point gap) of ans's rig against
    (R, t, X) over the points both hold, and the points only one holds."""
    n_kp = len(scene["local"])
    mine = _key(ans.point_keys, (1 << 20, 1 << 8, n_kp))
    theirs = _key(pkeys, (1 << 20, 1 << 8, n_kp))
    common, i_mine, i_ref = np.intersect1d(mine, theirs, return_indices=True)
    gaps = ba.rig_gaps(ans.R, ans.t, ans.xyz[i_mine], R, t, X[i_ref], with_scale=not constrained)
    return gaps, (len(mine) - len(common)) + (len(theirs) - len(common))


def judge(ans: Answer, scene, constrained, sigma_m, percentile, seed):
    """{number: value} of one calibration (see the module's docstring)."""
    pipe = reference_pipeline(scene, constrained, sigma_m, percentile, seed)
    (cam, rot, pt), _lone = _gaps(ans, pipe.R, pipe.t, pipe.point_keys, pipe.xyz, scene, constrained)
    out = {
        "pipe_cam_gap_mm": 1e3 * cam, "pipe_rot_gap_deg": rot, "pipe_pt_gap_mm": 1e3 * pt,
        "pipe_kept_diff": float(len(np.setxor1d(_obs_key(pipe.obs_keys, scene), _obs_key(ans.obs_keys, scene)))),
    }
    del pipe
    R, t, pkeys, X, _cost, _it = reference_solution(scene, ans.obs_keys, ans.uv, constrained, sigma_m, seed)
    (cam, rot, pt), lone = _gaps(ans, R, t, pkeys, X, scene, constrained)
    err = _errors(ans, scene, ans.obs_keys, ans.uv)
    rmse = float(np.sqrt(np.nanmean(err**2)))
    kept = kept_by_rule(ans.before_filter, scene, percentile)
    kept_diff = len(np.setxor1d(kept, _obs_key(ans.obs_keys, scene))) + lone
    out |= {
        "cam_gap_mm": 1e3 * cam, "rot_gap_deg": rot, "pt_gap_mm": 1e3 * pt,
        "rmse_gap": abs(ans.rmse_px - rmse) / rmse, "kept_diff": float(kept_diff),
    }
    if constrained:
        edges = truss_edges(scene["charuco"], scene["spacing"])
        ref_rig = rigidity_rmse_mm(pkeys, X, edges, scene["charuco"])
        out["rigidity_gap_mm"] = abs(ans.rigidity_mm - ref_rig)
    return out


def control_answer(scene, constrained, sigma_m, percentile, seed):
    """The control: the reference in bfloat16 put in the program's place
    (its robust stage, filter and final stage from the scene's
    observations, and its own reports), as an Answer for `judge`."""
    return reference_pipeline(scene, constrained, sigma_m, percentile, seed + 1, round_to="bfloat16")
