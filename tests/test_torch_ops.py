"""The port's tensor operations held against the JAX package's.

Same inputs (numpy, from a seed) through caliscope_tpu.ops.* (x64 on the
CPU, from conftest) and caliscope_tpu_torch.ops.* (float64 CPU tensors).
Both sides evaluate the same formulas in different orders (and the port's
Jacobian blocks are closed forms where the JAX package uses forward-mode
autodiff), so they agree to float64 roundoff: TOL = 1e-10, relative with
an absolute floor of the same size, far above the ~1e-14 differences seen
and far below any meaningful error.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caliscope_tpu.ops.lie as JL
import caliscope_tpu.ops.projection as JP
import caliscope_tpu.ops.reprojection as JR
import caliscope_tpu.ops.triangulate as JT
import caliscope_tpu_torch.ops.lie as TL
import caliscope_tpu_torch.ops.projection as TP
import caliscope_tpu_torch.ops.reprojection as TR
import caliscope_tpu_torch.ops.triangulate as TT

TOL = 1e-10


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def close(port, jax_out, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(jax_out), rtol=tol, atol=tol)


def _rvecs(rng):
    """Generic rotations plus the special cases: identity, tiny angles (the
    series branch) and angles near pi (the quaternion pivot switch)."""
    generic = rng.normal(size=(12, 3))
    axis = rng.normal(size=(3, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    special = np.concatenate(
        [np.zeros((1, 3)), 1e-5 * axis[:1], 3e-9 * axis[1:2], (np.pi - 1e-4) * axis[2:3]]
    )
    return np.concatenate([generic, special])


def test_so3_exp_and_log(rng):
    rv = _rvecs(rng)
    close(TL.so3_exp(t(rv)), JL.so3_exp(jnp.asarray(rv)))
    R = np.asarray(JL.so3_exp(jnp.asarray(rv)))
    close(TL.so3_log(t(R)), JL.so3_log(jnp.asarray(R)))


def test_so3_exp_jacobian_matches_autodiff(rng):
    rv = _rvecs(rng)
    want = jax.vmap(jax.jacfwd(JL.so3_exp))(jnp.asarray(rv))
    close(TL.so3_exp_jacobian(t(rv)), want)


def test_host_twins_are_the_jax_numpy_path_bit_for_bit(rng):
    """cameras.py writes rvecs through these; files must match the JAX
    package's byte for byte, so the results must be identical."""
    for rv in _rvecs(rng):
        np.testing.assert_array_equal(TL.so3_exp_host(rv), JL.so3_exp(rv))
        R = JL.so3_exp(rv)
        np.testing.assert_array_equal(TL.so3_log_host(R), JL.so3_log(R))


def test_se3_helpers(rng):
    R = np.asarray(JL.so3_exp(jnp.asarray(rng.normal(size=(4, 3)))))
    tv = rng.normal(size=(4, 3))
    X = rng.normal(size=(4, 3))
    close(TL.se3_matrix(t(R), t(tv)), JL.se3_matrix(jnp.asarray(R), jnp.asarray(tv)))
    for tp, jx in zip(TL.se3_inverse(t(R), t(tv)), JL.se3_inverse(jnp.asarray(R), jnp.asarray(tv))):
        close(tp, jx)
    for tp, jx in zip(
        TL.se3_compose(t(R), t(tv), t(R[::-1].copy()), t(tv[::-1].copy())),
        JL.se3_compose(jnp.asarray(R), jnp.asarray(tv), jnp.asarray(R[::-1]), jnp.asarray(tv[::-1])),
    ):
        close(tp, jx)
    close(TL.se3_apply(t(R), t(tv), t(X)), JL.se3_apply(jnp.asarray(R), jnp.asarray(tv), jnp.asarray(X)))


def _camera(rng, fisheye):
    K = np.array([[900.0, 0.0, 640.0], [0.0, 880.0, 360.0], [0.0, 0.0, 1.0]])
    dist = np.array([-0.05, 0.01, 0.002, -0.001]) if fisheye else np.array([0.1, -0.05, 0.001, -0.001, 0.01])
    rvec = rng.normal(size=3) * 0.3
    tvec = np.array([0.1, -0.2, 3.0])
    return K, dist, rvec, tvec


@pytest.mark.parametrize("fisheye", [False, True], ids=["brown", "fisheye"])
def test_project_points(rng, fisheye):
    K, dist, rvec, tvec = _camera(rng, fisheye)
    X = rng.uniform(-1, 1, size=(64, 3))
    want = JP.project_points(jnp.asarray(X), jnp.asarray(rvec), jnp.asarray(tvec), jnp.asarray(K), jnp.asarray(dist), fisheye)
    close(TP.project_points(t(X), t(rvec), t(tvec), t(K), t(dist), fisheye), want)


@pytest.mark.parametrize("fisheye", [False, True], ids=["brown", "fisheye"])
@pytest.mark.parametrize("output", ["normalized", "pixels"])
def test_undistort_points(rng, fisheye, output):
    K, dist, _, _ = _camera(rng, fisheye)
    uv = rng.uniform([0, 0], [1280, 720], size=(128, 2))
    want = JP.undistort_points(jnp.asarray(uv), jnp.asarray(K), jnp.asarray(dist), fisheye, output=output)
    close(TP.undistort_points(t(uv), t(K), t(dist), fisheye, output=output), want)


def _views(rng, n_cams=5, n_pts=40):
    """Normalized observations of random points from a ring of cameras."""
    Rs, Ps = [], []
    for i in range(n_cams):
        a = 2 * np.pi * i / n_cams
        c = np.array([3 * np.cos(a), 3 * np.sin(a), 1.0])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Rs.append(R)
        Ps.append(np.concatenate([R, (-R @ c)[:, None]], axis=1))
    P = np.stack(Ps)
    X = rng.uniform(-0.5, 0.5, size=(n_pts, 3))
    q = np.einsum("cij,pj->pci", P[:, :, :3], X) + P[None, :, :, 3]
    xn = q[..., :2] / q[..., 2:3] + rng.normal(scale=1e-3, size=(n_pts, n_cams, 2))
    return P, xn, X


def test_triangulate_dlt(rng):
    """Points, never eigenvectors (their signs are the library's choice)."""
    P, xn, _X = _views(rng)
    mask = rng.uniform(size=xn.shape[:2]) < 0.7
    mask[:, :2] = True  # >= 2 views everywhere
    Pv = np.broadcast_to(P, (xn.shape[0],) + P.shape)
    want = JT.triangulate_dlt(jnp.asarray(Pv), jnp.asarray(xn), jnp.asarray(mask))
    close(TT.triangulate_dlt(t(Pv), t(xn), t(mask, torch.bool)), want, tol=1e-9)


def test_triangulate_groups(rng):
    P, xn, _X = _views(rng)
    n_pts, n_cams = xn.shape[:2]
    keep = rng.uniform(size=(n_pts, n_cams)) < 0.7
    keep[:, :2] = True
    pt_idx, cam_idx = np.nonzero(keep)
    order = rng.permutation(len(pt_idx))  # observation order must not matter
    pt_idx, cam_idx = pt_idx[order], cam_idx[order]
    obs = xn[pt_idx, cam_idx]
    n_points, max_views = 64, 8
    want_xyz, want_n = JT.triangulate_groups(
        jnp.asarray(P), jnp.asarray(cam_idx), jnp.asarray(obs), jnp.asarray(pt_idx), n_points, max_views
    )
    got_xyz, got_n = TT.triangulate_groups(t(P), t(cam_idx, torch.int64), t(obs), t(pt_idx, torch.int64), n_points, max_views)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    close(got_xyz[:n_pts], np.asarray(want_xyz)[:n_pts], tol=1e-9)


def _dense_inputs(rng, C=4, P=48):
    """A mixed rig (camera 2 fisheye) in the dense point-minor layout, with
    one point behind camera 0 and the point axis ragged."""
    cam9, K0, dist0, fe = [], [], [], []
    for c in range(C):
        fisheye = c == 2
        K, dist, rvec, tvec = _camera(rng, fisheye)
        d5 = np.zeros(5)
        d5[: len(dist)] = dist
        cam9.append(np.concatenate([rvec, tvec, [rng.uniform(0.9, 1.1)], d5[:2]]))
        K0.append(K)
        dist0.append(d5)
        fe.append(fisheye)
    cam9, K0, dist0, fe = np.asarray(cam9), np.asarray(K0), np.asarray(dist0), np.asarray(fe)
    X = rng.uniform(-1, 1, size=(P, 3))
    X[5] = [0.0, 0.0, -4.0]  # behind the cameras
    uv_t = rng.uniform([0, 0], [1280, 720], size=(P, C, 2)).transpose(1, 2, 0).copy()
    inv_fx = 1.0 / K0[:, 0, 0]
    return cam9, X, uv_t, K0, dist0, fe, inv_fx


@pytest.mark.parametrize("any_fisheye", [True, False], ids=["mixed", "brown_only"])
def test_dense_residuals_and_blocks(rng, any_fisheye):
    cam9, X, uv_t, K0, dist0, fe, inv_fx = _dense_inputs(rng)
    if not any_fisheye:
        fe = np.zeros_like(fe)
    jargs = [jnp.asarray(a) for a in (cam9, X, uv_t, K0, dist0, fe, inv_fx)]
    targs = [t(cam9), t(X), t(uv_t), t(K0), t(dist0), t(fe, torch.bool), t(inv_fx)]
    close(TR.dense_observation_residuals(*targs, any_fisheye), JR.dense_observation_residuals(*jargs, any_fisheye))
    for got, want in zip(
        TR.dense_observation_jacobian_blocks(*targs, any_fisheye),
        JR.dense_observation_jacobian_blocks(*jargs, any_fisheye),
    ):
        assert tuple(got.shape) == tuple(want.shape)
        close(got, want)


def test_masked_dense_blocks(rng):
    """The solver's view of the blocks: a mixed rig with a mask, frozen
    intrinsics zeroed (bundle._masked_blocks_dense on both sides)."""
    from caliscope_tpu.solvers import bundle as JB
    from caliscope_tpu_torch.solvers import bundle as TB

    cam9, X, uv_t, K0, dist0, fe, _ = _dense_inputs(rng)
    C, P = uv_t.shape[0], uv_t.shape[2]
    mask = rng.uniform(size=(P, C)) < 0.6
    pt_idx, cam_idx = np.nonzero(mask)
    uv = uv_t.transpose(2, 0, 1)[pt_idx, cam_idx]
    jp = JB.make_dense_problem(cam_idx, pt_idx, uv, K0, dist0, fe, n_points=P)
    tp = TB.make_dense_problem(cam_idx, pt_idx, uv, K0, dist0, fe, n_points=P, device="cpu")
    for loss in ("linear", "soft_l1"):
        want = JB._masked_blocks_dense(jp, jnp.asarray(cam9), jnp.asarray(X), loss, 1e-3)
        r, w, Jc, Jp, cost = TB._masked_blocks_dense(tp, t(cam9), t(X), loss, 1e-3)
        for got, exp in zip((r, w, Jc, Jp, cost), (want[0], want[1], want[2], want[3], want[7])):
            close(got, exp)


@pytest.mark.parametrize("loss", ["linear", "soft_l1"])
def test_robust_weights_and_cost(rng, loss):
    r2 = rng.uniform(0, 4e-5, size=200) ** 2
    w_t, c_t = TR.robust_weights_and_cost(t(r2), loss, 2e-3)
    w_j, c_j = JR.robust_weights_and_cost(jnp.asarray(r2), loss, 2e-3)
    close(w_t, w_j)
    close(c_t, c_j)
    with pytest.raises(ValueError):
        TR.robust_weights_and_cost(t(r2), "cauchy", 1.0)


def test_reprojection_errors(rng):
    cam9, X, uv_t, K0, dist0, fe, _ = _dense_inputs(rng)
    C, P = uv_t.shape[0], uv_t.shape[2]
    cam_idx = rng.integers(0, C, size=100)
    pt_idx = rng.integers(0, P, size=100)
    uv = rng.uniform([0, 0], [1280, 720], size=(100, 2))
    want = JR.reprojection_errors(*(jnp.asarray(a) for a in (cam9, X, cam_idx, pt_idx, uv, K0, dist0, fe)))
    got = TR.reprojection_errors(
        t(cam9), t(X), t(cam_idx, torch.int64), t(pt_idx, torch.int64), t(uv), t(K0), t(dist0), t(fe, torch.bool)
    )
    close(got, want)
