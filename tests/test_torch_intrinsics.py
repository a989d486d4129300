"""The port's intrinsic solver (caliscope_tpu_torch.solvers.intrinsics)
held against the JAX package's on the same numpy inputs, the port on the
CPU in float64 and the JAX package in x64 (tests/conftest.py).

Tolerances: K within 1e-6 relative, distortion within 1e-6 absolute, RMSE
within 1e-9 relative, the same LM iteration count and convergence flag
(observed: K ~1e-15 relative, distortion ~3e-14). The JAX package takes J by
jax.jacfwd and the port in closed form; that closed form is held to
torch.func.jacfwd within 1e-10. The JAX solves run once per input in module
fixtures.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caliscope_tpu.ops.pnp import homography_dlt as j_homography_dlt
from caliscope_tpu.solvers import intrinsics as JI
from caliscope_tpu_torch.solvers import intrinsics as TI
from test_intrinsics import DIST_TRUE, K_TRUE, _pack, _single_cam_dataset

K_FISHEYE = np.array([[620.0, 0, 640.0], [0, 618.0, 360.0], [0, 0, 1.0]])
DIST_FISHEYE = np.array([0.08, -0.02, 0.005, -0.001])
SIZE = (1280, 720)

# name -> (fisheye, f_scale_px, image size the solver is told, max_iter)
CASES = {
    "brown_quadratic": (False, None, SIZE, 300),
    "brown_soft_l1": (False, 1.0, SIZE, 300),
    "fisheye_quadratic": (True, None, SIZE, 300),
    "fisheye_soft_l1": (True, 1.0, SIZE, 300),
    # A declared width of 40 px makes the true fx (870 px > 20 x 40) fail
    # the plausibility check, so the solve restarts from the neutral K
    # (0.8 x 40 px, centered) and keeps the lower-cost answer. Eight LM
    # iterations leave the restart far from the minimum the first solve
    # nears, so the costs decide by orders of magnitude (run to convergence,
    # both reach the same minimum and roundoff would break the tie).
    "restart": (False, None, (40, 720), 8),
}


def _data(fisheye, n_frames=12, seed=11):
    K, d = (K_FISHEYE, DIST_FISHEYE) if fisheye else (K_TRUE, DIST_TRUE)
    fo, fi, _ = _single_cam_dataset(K, d, n_frames=n_frames, fisheye=fisheye, seed=seed)
    return _pack(fo, fi)


def _same_result(got, want):
    np.testing.assert_allclose(got.K, want.K, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.dist, want.dist, rtol=0, atol=1e-6)
    assert got.rmse == pytest.approx(want.rmse, rel=1e-9)
    assert (got.n_iterations, got.converged, got.n_frames) == (want.n_iterations, want.converged, want.n_frames)
    np.testing.assert_allclose(got.tvecs, want.tvecs, rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def solved():
    out = {}
    for name, (fisheye, f_scale, size, max_iter) in CASES.items():
        obj, img, mask = _data(fisheye)
        out[name] = (
            (obj, img, mask),
            JI.solve_intrinsics(obj, img, mask, size, fisheye=fisheye, f_scale_px=f_scale, max_iter=max_iter),
        )
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_intrinsics_matches_jax(name, solved):
    fisheye, f_scale, size, max_iter = CASES[name]
    (obj, img, mask), want = solved[name]
    got = TI.solve_intrinsics(obj, img, mask, size, fisheye=fisheye, f_scale_px=f_scale, max_iter=max_iter, device="cpu")
    _same_result(got, want)
    assert got.restarted == (name == "restart")
    assert got.n_frames_bucketed == 16
    # one stop-flag read per LM iteration, plus the plausibility check and
    # the residual copy (and the restart's own reads)
    if name != "restart":
        assert got.host_reads == got.n_iterations + 3
    if name == "brown_quadratic":
        assert abs(got.K[0, 0] - K_TRUE[0, 0]) / K_TRUE[0, 0] < 0.01


@pytest.mark.parametrize("fisheye", [False, True], ids=["brown", "fisheye"])
@pytest.mark.parametrize("fix_aspect", [False, True], ids=["free_aspect", "fixed_aspect"])
def test_closed_form_jacobian_equals_forward_mode(fisheye, fix_aspect):
    """The solver's closed-form J against torch.func.jacfwd of the residual
    (the reference's jax.jacfwd), float64, at a perturbed point with
    distortion, a masked corner and an all-masked padding frame."""
    obj, img, mask = _data(fisheye, n_frames=8)
    mask[2, 3] = False
    mask[-1] = False
    n_dist = 4 if fisheye else 5
    rng = np.random.default_rng(1)
    K, d = (K_FISHEYE, DIST_FISHEYE) if fisheye else (K_TRUE, DIST_TRUE)
    pose = np.concatenate([rng.normal(scale=0.3, size=(len(obj), 3)), rng.normal(scale=0.05, size=(len(obj), 3)) + [0, 0, 0.8]], 1)
    params = torch.tensor(np.concatenate([K[[0, 1, 0, 1], [0, 1, 2, 2]] * 1.01, d * 0.9, pose.ravel()]))
    o, i, m = torch.tensor(obj), torch.tensor(img), torch.tensor(mask, dtype=torch.float64)
    want = torch.func.jacfwd(lambda q: TI._residuals(q, o, i, m, n_dist, fisheye, fix_aspect).reshape(-1))(params)
    got = TI._jacobian(params, o, m, n_dist, fisheye, fix_aspect)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10 * float(want.abs().max()))


def test_zhang_matches_jax_for_either_sign_of_b():
    """Closed-form K from the same homographies, within 1e-9 relative, and
    the same K from b and from -b (eigh may return either)."""
    obj, img, mask = _data(False)
    H = np.asarray(j_homography_dlt(jnp.asarray(obj[..., :2]), jnp.asarray(img), jnp.asarray(mask)))
    ok = mask.sum(axis=1) >= 4
    want = np.asarray(JI.zhang_intrinsics_from_homographies(jnp.asarray(H), jnp.asarray(ok)))
    Ht, okt = torch.tensor(H), torch.tensor(ok)
    got = TI.zhang_intrinsics_from_homographies(Ht, okt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * want[0, 0])
    b = TI._zhang_b(Ht, okt)
    np.testing.assert_allclose(TI._k_from_zhang_b(-b).numpy(), TI._k_from_zhang_b(b).numpy(), rtol=1e-12)
    # the closed form ignores distortion (k1 = -0.21 here): an init, ~22 % off
    assert 0.5 < got[0, 0] / K_TRUE[0, 0] < 2.0


def test_padding_is_inert(solved):
    """Masked padding corners and all-masked frames (the K and F buckets
    grow from 64 x 16 to 128 x 32) leave the answer as it was."""
    (obj, img, mask), want = solved["brown_quadratic"]
    F, K = mask.shape
    obj_p = np.zeros((F + 8, 65, 3))
    img_p = np.zeros((F + 8, 65, 2))
    mask_p = np.zeros((F + 8, 65), bool)
    obj_p[:F, :K], img_p[:F, :K], mask_p[:F, :K] = obj, img, mask
    got = TI.solve_intrinsics(obj_p, img_p, mask_p, SIZE, device="cpu")
    assert got.n_frames_bucketed == 32 and got.n_frames == F + 8
    np.testing.assert_allclose(got.K, want.K, rtol=1e-9)
    np.testing.assert_allclose(got.dist, want.dist, atol=1e-9)
    assert got.rmse == pytest.approx(want.rmse, rel=1e-9)
    assert got.n_iterations == want.n_iterations
    np.testing.assert_allclose(got.tvecs[:F], want.tvecs, atol=1e-8)


def test_solve_raises_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    obj, img, mask = _data(False, n_frames=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TI.solve_intrinsics(obj, img, mask, SIZE)


@pytest.mark.cuda
def test_solve_on_cuda_matches_cpu_float64():
    """The card's default (float64) solve within 1e-9 relative of the CPU's
    on K and converged; a float32 solve on the card within
    1e-3 relative on K, 5e-3 on distortion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    obj, img, mask = _data(False)
    cpu = TI.solve_intrinsics(obj, img, mask, SIZE, f_scale_px=1.0, device="cpu")
    f64 = TI.solve_intrinsics(obj, img, mask, SIZE, f_scale_px=1.0, device="cuda")
    f32 = TI.solve_intrinsics(obj, img, mask, SIZE, f_scale_px=1.0, device="cuda", dtype=torch.float32)
    np.testing.assert_allclose(f32.K, cpu.K, rtol=1e-3)
    np.testing.assert_allclose(f32.dist, cpu.dist, atol=5e-3)
    np.testing.assert_allclose(f64.K, cpu.K, rtol=1e-9)
    assert f64.converged
