"""The port's batched PnP (caliscope_tpu_torch/ops/pnp.py) held against
caliscope_tpu/ops/pnp.py.

Seeded planar and non-planar groups with padded masks (and all-filler
groups, as the bootstrap's bucketing makes them) go through both packages,
the JAX package in x64 (tests/conftest.py), the port in float64 on the CPU.
Eigenvector and singular-vector signs differ between the two LAPACK paths,
so intermediates are not compared; the sign-free outputs are: the
homography scaled to H[2,2] = 1, and poses as rotation matrices (an rvec
near pi may come out as its antipodal twin). Tolerance POSE_TOL = 1e-9:
the two packages solve the same systems in other summation orders, and the
differences seen are ~1e-15; the closed-form Gauss-Newton Jacobian must
equal `jax.jacfwd` of the JAX residuals to 1e-12.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caliscope_tpu.ops.pnp as JP
from caliscope_tpu.ops.lie import so3_exp as jax_so3_exp
from caliscope_tpu.ops.projection import project_normalized as jax_project_normalized
import caliscope_tpu_torch.ops.pnp as TP
from caliscope_tpu_torch.ops.lie import so3_exp_host

POSE_TOL = 1e-9
JAC_TOL = 1e-12


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def make_groups(seed: int, planar: str, G: int = 10, K: int = 16, filler: int = 2, noise: float = 3e-4):
    """G groups of 6..K points seen from poses 1.2-1.8 m away, oblique, in
    normalized coordinates with noise, padded to K slots; `filler` trailing
    all-padding groups. planar: 'all', 'none' or 'mixed'."""
    rng = np.random.default_rng(seed)
    obj = np.zeros((G + filler, K, 3))
    img = np.zeros((G + filler, K, 2))
    mask = np.zeros((G + filler, K), bool)
    for g in range(G):
        n = int(rng.integers(6, K + 1))
        flat = planar == "all" or (planar == "mixed" and g % 2 == 0)
        if flat:
            pts = np.c_[rng.uniform(-0.2, 0.2, (n, 2)), np.zeros(n)]
        else:
            pts = rng.uniform(-0.2, 0.2, (n, 3))
        rv = rng.normal(size=3)
        rv *= rng.uniform(0.4, 1.0) / np.linalg.norm(rv)  # 23-57 deg: not fronto-parallel
        tv = np.array([0.05, -0.02, 1.5]) + rng.normal(size=3) * 0.1
        xc = pts @ so3_exp_host(rv).T + tv
        obj[g, :n] = pts
        img[g, :n] = xc[:, :2] / xc[:, 2:] + rng.normal(scale=noise, size=(n, 2))
        mask[g, :n] = True
    return obj, img, mask


def assert_same_poses(port_rv, port_t, jax_rv, jax_t, rows=slice(None)):
    port_rv, jax_rv = np.asarray(port_rv)[rows], np.asarray(jax_rv)[rows]
    np.testing.assert_allclose(so3_exp_host(port_rv), so3_exp_host(jax_rv), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(np.asarray(port_t)[rows], np.asarray(jax_t)[rows], atol=POSE_TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("planar", ["all", "none", "mixed"])
def test_solve_pnp_batch_matches_jax(seed, planar):
    obj, img, mask = make_groups(seed, planar)
    jr, jt, jrms, jn = JP.solve_pnp_batch(jnp.asarray(obj), jnp.asarray(img), jnp.asarray(mask))
    tr, tt, trms, tn = TP.solve_pnp_batch(t(obj), t(img), t(mask, torch.bool))
    real = slice(0, 10)  # filler groups are garbage in both (dropped by the caller)
    assert_same_poses(tr, tt, jr, jt, real)
    np.testing.assert_allclose(trms.numpy()[real], np.asarray(jrms)[real], rtol=1e-7, atol=1e-12)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # and the poses are right: rms at the noise level
    assert (trms.numpy()[real] < 1e-3).all()


def test_solve_pnp_batch_takes_the_second_lobe_where_it_fits_better():
    """An oblique flat board with noise: the IPPE second lobe, refined, must
    be chosen exactly where the JAX package chooses it, and both packages'
    rms equal; here at least one group takes lobe b."""
    obj, img, mask = make_groups(7, "all", G=24, noise=2e-3)
    jr, jt, jrms, _ = JP.solve_pnp_batch(jnp.asarray(obj), jnp.asarray(img), jnp.asarray(mask))
    tr, tt, trms, _ = TP.solve_pnp_batch(t(obj), t(img), t(mask, torch.bool))
    assert_same_poses(tr, tt, jr, jt, slice(0, 24))
    np.testing.assert_allclose(trms.numpy()[:24], np.asarray(jrms)[:24], rtol=1e-7)


@pytest.mark.parametrize("seed", [3, 4])
def test_homography_dlt_matches_jax(seed):
    obj, img, mask = make_groups(seed, "all")
    src = obj[..., :2]
    jH = np.asarray(JP.homography_dlt(jnp.asarray(src), jnp.asarray(img), jnp.asarray(mask)))
    tH = TP.homography_dlt(t(src), t(img), t(mask, torch.bool)).numpy()
    np.testing.assert_allclose(tH[:10], jH[:10], atol=POSE_TOL, rtol=0)
    # and maps the board onto its image
    h = np.einsum("gij,gkj->gki", tH, np.concatenate([src, np.ones_like(src[..., :1])], -1))[:10][mask[:10]]
    err = np.linalg.norm(h[:, :2] / h[:, 2:] - img[:10][mask[:10]], axis=-1)
    assert err.max() < 5e-3


def test_pose_from_homography_matches_jax():
    obj, img, mask = make_groups(5, "all")
    H = np.asarray(JP.homography_dlt(jnp.asarray(obj[..., :2]), jnp.asarray(img), jnp.asarray(mask)))[:10]
    jr, jt = JP.pose_from_homography(jnp.asarray(H))
    tr, tt = TP.pose_from_homography(t(H))
    assert_same_poses(tr, tt, jr, jt)


@pytest.mark.parametrize("seed", [6, 8])
def test_projection_dlt_matches_jax(seed):
    obj, img, mask = make_groups(seed, "none")
    jr, jt = JP.projection_dlt(jnp.asarray(obj), jnp.asarray(img), jnp.asarray(mask))
    tr, tt = TP.projection_dlt(t(obj), t(img), t(mask, torch.bool))
    assert_same_poses(tr, tt, jr, jt, slice(0, 10))


def test_orthonormalize_matches_jax(rng):
    M = rng.normal(size=(12, 3, 3))
    got = TP._orthonormalize(t(M)).numpy()
    np.testing.assert_allclose(got, np.asarray(JP._orthonormalize(jnp.asarray(M))), atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-12)


@pytest.mark.parametrize("weights", ["mask", "float"])
def test_refine_pose_gn_matches_jax(weights):
    """From the same perturbed start, with a validity mask or float weights
    (as pnp_ransac passes its inliers); batched and single-group calls.
    Non-planar groups: the DLT start is sane only off a plane."""
    obj, img, mask = make_groups(9, "none")
    rng = np.random.default_rng(10)
    jr0, jt0 = JP.projection_dlt(jnp.asarray(obj), jnp.asarray(img), jnp.asarray(mask))
    rv0 = np.asarray(jr0)[:10] + rng.normal(scale=0.02, size=(10, 3))
    tv0 = np.asarray(jt0)[:10] + rng.normal(scale=0.02, size=(10, 3))
    w = mask[:10] if weights == "mask" else mask[:10] * rng.uniform(0.5, 1.0, size=mask[:10].shape)
    want = np.asarray(JP.refine_pose_gn(jnp.asarray(obj[:10]), jnp.asarray(img[:10]), jnp.asarray(w), jnp.asarray(rv0), jnp.asarray(tv0)))
    got = TP.refine_pose_gn(t(obj[:10]), t(img[:10]), t(w, torch.bool if weights == "mask" else torch.float64), t(rv0), t(tv0)).numpy()
    assert_same_poses(got[:, :3], got[:, 3:], want[:, :3], want[:, 3:])
    one = TP.refine_pose_gn(t(obj[0]), t(img[0]), t(w[0]), t(rv0[0]), t(tv0[0]), iters=10).numpy()
    one_j = np.asarray(JP.refine_pose_gn(jnp.asarray(obj[0]), jnp.asarray(img[0]), jnp.asarray(w[0]), jnp.asarray(rv0[0]), jnp.asarray(tv0[0]), iters=10))
    assert one.shape == (6,)
    np.testing.assert_allclose(one, one_j, atol=POSE_TOL)


@pytest.mark.parametrize("case", ["generic", "small_angle", "near_pi", "clamped_depth"])
def test_gn_jacobian_matches_jacfwd(case, rng):
    """The closed-form Jacobian of project_normalized w.r.t. (rvec, t)
    against jax.jacfwd in float64, including the so3_exp series branch and
    points whose depth is clamped (where the derivative through z is 0)."""
    rvec = {"generic": rng.normal(size=3), "small_angle": np.array([2e-9, -1e-9, 3e-9]),
            "near_pi": np.array([0.0, np.pi - 1e-5, 0.0])}.get(case, rng.normal(size=3) * 0.3)
    theta = np.concatenate([rvec, [0.1, -0.2, 2.0]])
    X = rng.normal(size=(7, 3)) * 0.4
    if case == "clamped_depth":
        R = np.asarray(jax_so3_exp(jnp.asarray(rvec)))
        X[:2] = (np.array([[0.3, 0.1, -2.0], [-0.1, 0.2, -2.0 + 5e-7]]) - theta[3:]) @ R  # z_cam = 0 and 5e-7
    want = np.asarray(jax.jacfwd(lambda th: jax_project_normalized(jnp.asarray(X), th[:3], th[3:]))(jnp.asarray(theta)))
    uv, J = TP.project_normalized_jacobian(t(X)[None], t(theta)[None])
    np.testing.assert_allclose(J[0].numpy(), want, atol=JAC_TOL, rtol=JAC_TOL)
    np.testing.assert_allclose(uv[0].numpy(), np.asarray(jax_project_normalized(jnp.asarray(X), theta[:3], theta[3:])), atol=JAC_TOL)
