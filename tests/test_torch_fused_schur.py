"""The fused Schur assembly of the port (caliscope_tpu_torch.solvers.
fused_schur) held against the JAX package's.

Here, on the CPU, the wrapper computes its plain version; the CUDA kernel
itself is checked against that plain version on the card by chip_smoke.py
(and by the `cuda`-marked test below, which skips without a GPU). The plain
version is pinned to:
  (a) pallas_schur.schur_s_rhs_reference in float64, rhs and Hpp_inv to
      1e-10. S to 1e-6 relative: the reference contracts S with
      preferred_element_type=float32, so its S is float32 even for float64
      inputs (rounding ~6e-8 relative);
  (b) the Pallas kernel itself (_schur_s_rhs_impl in interpret mode, patched
      as tests/test_pallas_kernels.py patches it), float32 at C=8, P=1024,
      with that test's 1e-4 tolerance;
  (c) bundle._pminor_hpp_inv, to 1e-12 in float64.
The CUDA kernel computes only S's upper triangle and mirrors it; the plain
version's S is symmetric to roundoff (1e-12 relative to the entry's scale in
float64, 1e-5 in float32: two summation orders of the same products), so the
mirrored S stays within the kernel's rtol = atol = 1e-3 of it.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caliscope_tpu.solvers.pallas_schur as PS
from caliscope_tpu_torch.solvers import fused_schur as FS

LAM = 1e-3


def _blocks(rng, C=8, P=1024, dtype=np.float32, pin=None):
    Jc = (rng.normal(size=(C, 2, 9, P)) * 0.1).astype(dtype)
    Jp = (rng.normal(size=(C, 2, 3, P)) * 0.1).astype(dtype)
    w = rng.uniform(0.5, 1.0, size=(C, 2, P)).astype(dtype)
    bp = rng.normal(size=(3, P)).astype(dtype)
    if pin is not None:  # an unobserved point: the pinning branch
        w[:, :, pin] = 0.0
        Jp[:, :, :, pin] = 0.0
    return Jc, Jp, w, bp


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("C,P", [(3, 256), (8, 300), (5, 1000), (1, 7)], ids=["tiled", "ragged", "five_cameras", "one_camera"])
def test_plain_matches_reference_f64(rng, C, P):
    pin = min(7, P - 1)
    blocks = _blocks(rng, C, P, np.float64, pin=pin)
    got = FS.schur_s_rhs_plain(*_t(blocks), LAM)
    want = PS.schur_s_rhs_reference(*(jnp.asarray(a) for a in blocks), LAM)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-10, atol=1e-10)
    # the pinned point's block is the damped identity's inverse
    np.testing.assert_allclose(got[2][:, :, pin].numpy(), np.eye(3) / (1 + LAM + 1e-12), rtol=1e-12)


@pytest.mark.parametrize("C,lam", [(5, LAM), (1, 1.0)], ids=["five_cameras", "one_camera"])
def test_plain_matches_interpreted_pallas_kernel_at_camera_counts_off_the_tile(rng, monkeypatch, C, lam):
    """9C = 45 and 9 are no multiples of the CUDA kernel's 8-row tiles. With
    one camera every point block has rank 2, so its damped inverse is of
    order 1 / lam and magnifies float32 roundoff by as much: that case runs
    at lam = 1, where the comparison says something about the arithmetic."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    blocks = _blocks(rng, C=C, P=1024, pin=7)
    want = PS._schur_s_rhs_impl(*(jnp.asarray(a) for a in blocks), lam)
    got = FS.schur_s_rhs(*_t(blocks), lam)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)], ids=["float64", "float32"])
@pytest.mark.parametrize("C,P", [(8, 2048), (5, 1000)], ids=["eight_cameras", "five_cameras"])
def test_plain_S_is_symmetric_to_roundoff(rng, dtype, tol, C, P):
    blocks = _blocks(rng, C, P, dtype, pin=7)
    S = FS.schur_s_rhs_plain(*_t(blocks), LAM)[0].numpy()
    scale = np.sqrt(np.outer(np.diag(S), np.diag(S)))  # |S_ij| <= sqrt(S_ii S_jj): S is positive semi-definite
    assert (np.diag(S) > 0).all()
    assert np.abs(S - S.T).max() > 0 or dtype == np.float64  # not symmetric by construction
    assert (np.abs(S - S.T) <= tol * scale).all()


def test_plain_matches_interpreted_pallas_kernel(rng, monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    blocks = _blocks(rng, C=8, P=1024, pin=7)
    # the UNJITTED impl, as the JAX package's own test runs it
    want = PS._schur_s_rhs_impl(*(jnp.asarray(a) for a in blocks), LAM)
    got = FS.schur_s_rhs(*_t(blocks), LAM)  # CPU tensors: the plain version
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_hpp_inv_matches_bundle_helper(rng):
    from caliscope_tpu.solvers import bundle as JB

    _, Jp, w, _ = _blocks(rng, P=256, dtype=np.float64, pin=7)

    class _Problem:
        n_constraints = 0

    want = JB._pminor_hpp_inv(_Problem(), jnp.asarray(w), jnp.asarray(Jp), None, jnp.asarray(LAM), jnp.float64, None)
    got = FS.hpp_inv_plain(torch.from_numpy(Jp), torch.from_numpy(w), LAM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing(rng):
    blocks = _t(_blocks(rng, C=4, P=100))
    lam = torch.tensor([LAM], dtype=torch.float32)
    before = FS.schur_s_rhs.launches
    got = FS.schur_s_rhs(*blocks, lam)
    want = FS.schur_s_rhs_plain(*blocks, lam)
    assert FS.schur_s_rhs.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _bad_inputs(rng):
    Jc, Jp, w, bp = _t(_blocks(rng, C=2, P=40))
    meta = lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta")  # noqa: E731
    big = _t(_blocks(rng, C=FS.MAX_CAMERAS + 1, P=8))
    return {
        "float64": ((Jc.double(), Jp.double(), w.double(), bp.double(), LAM), TypeError),
        "one_float64": ((Jc, Jp, w.double(), bp, LAM), TypeError),
        "not_cpu_or_cuda": ((meta(Jc), meta(Jp), meta(w), meta(bp), LAM), ValueError),
        "mixed_devices": ((Jc, meta(Jp), w, bp, LAM), ValueError),
        "non_contiguous": ((Jc, Jp, w, torch.rand(40, 3).T, LAM), ValueError),
        "bad_jc_shape": ((Jc[:, :, :8], Jp, w, bp, LAM), ValueError),
        "bad_jp_shape": ((Jc, Jp[:1], w, bp, LAM), ValueError),
        "too_many_cameras": ((*big, LAM), ValueError),
        "lam_float64": ((Jc, Jp, w, bp, torch.tensor([LAM], dtype=torch.float64)), ValueError),
        "lam_two_values": ((Jc, Jp, w, bp, torch.tensor([LAM, LAM])), ValueError),
        "not_a_tensor": ((Jc.numpy(), Jp, w, bp, LAM), TypeError),
    }


BAD_CASES = (
    "float64", "one_float64", "not_cpu_or_cuda", "mixed_devices", "non_contiguous", "bad_jc_shape",
    "bad_jp_shape", "too_many_cameras", "lam_float64", "lam_two_values", "not_a_tensor",
)


@pytest.mark.parametrize("case", BAD_CASES)
def test_wrapper_raises_on_what_the_kernel_cannot_take(rng, case):
    args, exc = _bad_inputs(rng)[case]
    with pytest.raises(exc, match="schur_s_rhs"):
        FS.schur_s_rhs(*args)


def test_availability_rules():
    class _Problem:
        n_constraints = 0
        n_cameras = 8

        class uv:
            device = torch.device("cpu")

    assert not FS.fused_schur_available(_Problem(), 1024, torch.float32)  # CPU
    _Problem.uv.device = torch.device("cuda", 0)
    assert FS.fused_schur_available(_Problem(), 1000, torch.float32)  # any P, no %512 rule
    assert not FS.fused_schur_available(_Problem(), 1000, torch.float64)
    _Problem.n_cameras = FS.MAX_CAMERAS + 1
    assert not FS.fused_schur_available(_Problem(), 1000, torch.float32)


@pytest.mark.cuda
def test_compiled_kernel_matches_plain_on_cuda(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    for C, P in ((8, 4096), (8, 1001), (FS.MAX_CAMERAS, 97)):
        blocks = [b.cuda() for b in _t(_blocks(rng, C, P, pin=7))]
        lam = torch.tensor([LAM], dtype=torch.float32, device="cuda")
        before = FS.schur_s_rhs.launches
        got = FS.schur_s_rhs(*blocks, lam)
        want = FS.schur_s_rhs_plain(*blocks, lam)
        torch.cuda.synchronize()
        assert FS.schur_s_rhs.launches == before + 1
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("C,P", [(8, 40_960), (5, 1000), (1, 7), (9, 130), (13, 2049), (FS.MAX_CAMERAS, 4099)])
def test_compiled_kernel_is_symmetric_repeatable_and_takes_any_camera_count(rng, C, P):
    """Every tile plan: 9C off the 8-row tiles, fewer points than a tile, a
    point count off the 16-byte copies, one to eight slices a tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    blocks = [b.cuda() for b in _t(_blocks(rng, C, P, pin=min(7, P - 1)))]
    # one camera: rank-2 point blocks, inverses of order 1 / lam; see above
    lam = torch.tensor([1.0 if C == 1 else LAM], dtype=torch.float32, device="cuda")
    got = FS.schur_s_rhs(*blocks, lam)
    again = FS.schur_s_rhs(*blocks, lam)
    want = FS.schur_s_rhs_plain(*blocks, lam)
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[0].T)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)
