"""The port's RANSACs and two-view geometry (caliscope_tpu_torch/ops/
epipolar.py) held against caliscope_tpu/ops/epipolar.py.

The JAX package draws its minimal samples from threefry keys, which the
port's torch.Generator cannot reproduce, so each RANSAC is held in two
ways: its scorer on the JAX package's own sample indices (computed here
with JAX and fed to the port's scorer) must agree to float64 roundoff,
POSE_TOL = 1e-9 on poses, equal inlier sets and scores; and the whole
function, the port drawing its own samples, on clean data by its final
pose (within 1e-9: the same inliers polished by the same Gauss-Newton
steps) and inlier set. Essential matrices are compared up to their sign
(E and -E are the same constraint), normalized to unit norm.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caliscope_tpu.ops.epipolar as JE
import caliscope_tpu_torch.ops.epipolar as TE
from caliscope_tpu_torch.ops.lie import so3_exp_host
from torch_pose_common import jax_sample_indices

POSE_TOL = 1e-9


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def resection_data(seed: int, n: int = 50, pad: int = 14, outliers: int = 0, noise: float = 0.0):
    """n 3-D points 2-3 m in front of a camera, their normalized images
    (with `outliers` rows thrown 0.05 off), padded to n + pad rows."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-0.8, -0.6, -0.5], [0.8, 0.6, 0.5], size=(n, 3))
    rv, tv = rng.normal(size=3) * 0.4, np.array([0.1, -0.05, 2.5])
    xc = X @ so3_exp_host(rv).T + tv
    uv = xc[:, :2] / xc[:, 2:] + rng.normal(scale=noise, size=(n, 2))
    bad = rng.choice(n, size=outliers, replace=False)
    uv[bad] += 0.05 * rng.normal(size=(outliers, 2))
    obj = np.zeros((n + pad, 3))
    img = np.zeros((n + pad, 2))
    mask = np.zeros(n + pad, bool)
    obj[:n], img[:n], mask[:n] = X, uv, True
    return obj, img, mask, (rv, tv)


def two_view_data(seed: int, n: int = 60, pad: int = 4, outliers: int = 0):
    """Normalized correspondences of n points seen by camera a = [I|0] and
    camera b = [R|t] (|t| = 1), padded."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1, -1, 3], [1, 1, 5], size=(n, 3))
    R = so3_exp_host(np.array([0.05, -0.3, 0.02]) + rng.normal(scale=0.02, size=3))
    tv = np.array([1.0, 0.1, -0.05])
    tv /= np.linalg.norm(tv)
    xa = X[:, :2] / X[:, 2:]
    xb_c = X @ R.T + tv
    xb = xb_c[:, :2] / xb_c[:, 2:]
    bad = rng.choice(n, size=outliers, replace=False)
    xb[bad] += 0.05 * rng.normal(size=(outliers, 2))
    pa = np.zeros((n + pad, 2))
    pb = np.zeros((n + pad, 2))
    mask = np.zeros(n + pad, bool)
    pa[:n], pb[:n], mask[:n] = xa, xb, True
    return pa, pb, mask, (R, tv)


@pytest.mark.parametrize("seed,outliers", [(0, 0), (1, 8), (2, 15)])
def test_pnp_ransac_scorer_matches_jax_on_its_samples(seed, outliers):
    obj, img, mask, _ = resection_data(seed, outliers=outliers, noise=2e-4)
    thr = 3.0 / 1400.0
    idx = jax_sample_indices(t(mask, torch.bool), 128, 6, seed)
    jr, jt, jinl, jmed = JE.pnp_ransac(jnp.asarray(obj), jnp.asarray(img), jnp.asarray(mask), thr, seed=seed)
    tr, tt, tinl, tmed = TE.pnp_ransac_scored(t(obj), t(img), t(mask, torch.bool), thr, idx)
    np.testing.assert_allclose(so3_exp_host(tr.numpy()), so3_exp_host(np.asarray(jr)), atol=POSE_TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=POSE_TOL)
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    np.testing.assert_allclose(float(tmed), float(jmed), rtol=1e-9)
    assert int(tinl.sum()) >= 50 - outliers


@pytest.mark.parametrize("seed", [3, 4])
def test_pnp_ransac_end_to_end_on_clean_data(seed):
    """The port's own samples: the same final pose and inliers as the JAX
    package's on data without outliers (every hypothesis finds all rows)."""
    obj, img, mask, (rv, tv) = resection_data(seed, noise=1e-4)
    thr = 3.0 / 1400.0
    jr, jt, jinl, jmed = JE.pnp_ransac(jnp.asarray(obj), jnp.asarray(img), jnp.asarray(mask), thr, seed=seed)
    tr, tt, tinl, tmed = TE.pnp_ransac(t(obj), t(img), t(mask, torch.bool), thr, seed=seed)
    np.testing.assert_allclose(so3_exp_host(tr.numpy()), so3_exp_host(np.asarray(jr)), atol=POSE_TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=POSE_TOL)
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    np.testing.assert_allclose(float(tmed), float(jmed), rtol=1e-7)
    np.testing.assert_allclose(so3_exp_host(tr.numpy()), so3_exp_host(rv), atol=1e-3)


def test_sample_indices_draw_valid_rows_from_a_seeded_generator():
    mask = torch.zeros(40, dtype=torch.bool)
    mask[5:25] = True
    a = TE.sample_indices(mask, 64, 6, seed=3)
    assert a.shape == (64, 6) and a.dtype == torch.int64 and a.device == mask.device
    assert bool(mask[a].all())
    assert all(len(set(row.tolist())) == 6 for row in a)  # without replacement
    assert torch.equal(a, TE.sample_indices(mask, 64, 6, seed=3))
    assert not torch.equal(a, TE.sample_indices(mask, 64, 6, seed=4))


@pytest.mark.parametrize("values", [[3.0, 1.0, 4.0, 2.0], [5.0, 1.0, 2.0], [7.0], [2.5, 0.5]])
def test_nanmedian_takes_numpys_rule(values):
    """An even count averages the two middle values (jnp.nanmedian, which
    the scaffold ranks by), where torch.nanmedian would take the lower."""
    x = np.array(values + [np.nan] * 3)
    np.random.default_rng(0).shuffle(x)
    got = float(TE._nanmedian(t(x)))
    assert got == float(jnp.nanmedian(jnp.asarray(x)))
    assert got == float(np.nanmedian(x))
    assert np.isnan(float(TE._nanmedian(t([np.nan, np.nan]))))


@pytest.mark.parametrize("seed,outliers", [(5, 0), (6, 10)])
def test_essential_ransac_scorer_matches_jax_on_its_samples(seed, outliers):
    xa, xb, mask, _ = two_view_data(seed, outliers=outliers)
    thr = 1e-3
    idx = jax_sample_indices(t(mask, torch.bool), 256, 8, seed)
    jE, jinl, jn = JE.essential_ransac(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(mask), thr, seed=seed)
    tE, tinl, tn = TE.essential_ransac_scored(t(xa), t(xb), t(mask, torch.bool), thr, idx)

    def unit(E):
        E = np.asarray(E) / np.linalg.norm(E)
        return E * np.sign(E.flat[np.argmax(np.abs(E))])

    np.testing.assert_allclose(unit(tE.numpy()), unit(jE), atol=POSE_TOL)
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tn) == int(jn) >= 60 - outliers  # an outlier thrown along its epipolar line stays in


def essential(R, tv):
    return np.array([[0, -tv[2], tv[1]], [tv[2], 0, -tv[0]], [-tv[1], tv[0], 0]]) @ R


def test_sampson_distance_and_decompose_essential_match_jax():
    xa, xb, mask, (R, tv) = two_view_data(7)
    E = essential(R, tv)
    np.testing.assert_allclose(
        TE.sampson_distance(t(E), t(xa), t(xb)).numpy(), np.asarray(JE.sampson_distance(jnp.asarray(E), jnp.asarray(xa), jnp.asarray(xb))),
        atol=1e-15,
    )
    R1, R2, tt = TE.decompose_essential(t(E))
    jR1, jR2, jt = JE.decompose_essential(jnp.asarray(E))
    # as sets: {R1, R2}, and t up to sign (the four candidates recover_pose votes on)
    got, want = [R1.numpy(), R2.numpy()], [np.asarray(jR1), np.asarray(jR2)]
    if not np.allclose(got[0], want[0], atol=1e-9):
        got = got[::-1]
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-9)
    np.testing.assert_allclose(tt.numpy() * np.sign(tt.numpy() @ np.asarray(jt)), np.asarray(jt), atol=1e-9)
    for Rc in (R1.numpy(), R2.numpy()):
        np.testing.assert_allclose(Rc @ Rc.T, np.eye(3), atol=1e-12)
        assert np.linalg.det(Rc) > 0


@pytest.mark.parametrize("seed", [8, 9])
def test_recover_pose_picks_the_same_pose(seed):
    """On a clean pair, both pick the true (R, t) by cheirality, whatever
    order their SVDs give the four candidates in."""
    xa, xb, mask, (R, tv) = two_view_data(seed)
    E = essential(R, tv)
    jR, jt, jch = JE.recover_pose(jnp.asarray(E), jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(mask))
    tR, tt, tch = TE.recover_pose(t(E), t(xa), t(xb), t(mask, torch.bool))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=POSE_TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=POSE_TOL)
    np.testing.assert_array_equal(tch.numpy(), np.asarray(jch))
    np.testing.assert_allclose(tR.numpy(), R, atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), tv, atol=1e-9)
    assert int(tch.sum()) == 60
