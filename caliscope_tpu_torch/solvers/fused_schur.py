"""Fused Schur-complement assembly for the dense BA layout: the CUDA kernel's
wrapper and its plain PyTorch version.

Port of caliscope_tpu/solvers/pallas_schur.py. From the point-minor blocks
Jc (C,2,9,P), Jp (C,2,3,P), weights w (C,2,P), the point right-hand side
bp_t (3,P) and the damping lam, it returns

    S_raw   = sum_k Y_k G_k^T             (9C, 9C)
    rhs_raw = sum_k Y_k bp_k              (9C,)
    Hpp_inv                               (3, 3, P)

with G_k = sum_r (Jc w)[:, r] Jp[:, r, k] and Y_k = sum_j G_j Hpp_inv[j, k],
none of them negated — exactly what bundle._solve_schur consumes.

`schur_s_rhs` is the kernel wrapper. On CUDA tensors it launches the
hand-written kernel in csrc/schur_s_rhs.cu, which is compiled with nvcc
into a plain-C shared library on first use and loaded with ctypes (the
shared build helper, caliscope_tpu_torch/_cuda_build.py). On CPU tensors, and
only there, it computes `schur_s_rhs_plain`. One kernel takes every shape
the wrapper accepts: float32, contiguous, 1 to MAX_CAMERAS cameras, any
point count of at least one (a ragged last tile adds zeros); the S it
returns is exactly symmetric and the same bits on every run. The wrapper
raises on anything else, on either device, and a launch that the card
refuses raises too; whether to use the kernel at all is the solver's
decision (`fused_schur_available`).
"""

from __future__ import annotations

import ctypes

import torch

from caliscope_tpu_torch import _cuda_build

MAX_CAMERAS = 16  # the shared-memory plan's bound; checked against the library

_lib = None
_n_sm: dict[int, int] = {}  # CUDA device index -> its count of SMs


# ---------------------------------------------------------------------------
# The plain version (the math of pallas_schur.schur_s_rhs_reference)
# ---------------------------------------------------------------------------


def hpp_inv_plain(Jp, w, lam):
    """Damped inverse point blocks (3,3,P): pin zero-trace blocks with I,
    floor the diagonal at 1e-12, Hpp = d + lam*diag*I + 1e-12*I, closed-form
    symmetric inverse."""
    Up = Jp * w[:, :, None, :]
    d = torch.einsum("crip,crjp->ijp", Up, Jp)  # (3,3,P)
    eye = torch.eye(3, dtype=d.dtype, device=d.device)[:, :, None]
    pinned = (d[0, 0] + d[1, 1] + d[2, 2]) == 0
    d = d + pinned[None, None, :] * eye
    diag = torch.clamp(torch.stack([d[0, 0], d[1, 1], d[2, 2]]), min=1e-12)
    return inv3x3_pminor(d + lam * diag[:, None, :] * eye + 1e-12 * eye)


def inv3x3_pminor(A):
    """Closed-form symmetric-3x3 inverse in the point-minor (3, 3, P) layout."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e = A[1, 1], A[1, 2]
    f = A[2, 2]
    c00 = d * f - e * e
    c01 = c * e - b * f
    c02 = b * e - c * d
    c11 = a * f - c * c
    c12 = b * c - a * e
    c22 = a * d - b * b
    inv_det = 1.0 / (a * c00 + b * c01 + c * c02)
    rows = torch.stack(
        [torch.stack([c00, c01, c02]), torch.stack([c01, c11, c12]), torch.stack([c02, c12, c22])]
    )
    return rows * inv_det


def schur_s_rhs_plain(Jc, Jp, w, bp_t, lam):
    """(S_raw, rhs_raw, Hpp_inv) in plain tensor operations, on any device."""
    Hpp_inv = hpp_inv_plain(Jp, w, lam)
    U = Jc * w[:, :, None, :]
    G = torch.einsum("crip,crkp->cikp", U, Jp)  # (C,9,3,P)
    n_cp = Jc.shape[0] * Jc.shape[2]
    S = 0
    rhs = 0
    for k in range(3):
        Yk = sum(G[:, :, j, :] * Hpp_inv[j, k][None, None, :] for j in range(3)).reshape(n_cp, -1)
        S = S + Yk @ G[:, :, k, :].reshape(n_cp, -1).T
        rhs = rhs + Yk @ bp_t[k]
    return S, rhs, Hpp_inv


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _library():
    global _lib
    if _lib is None:
        lib = _cuda_build.load("schur_s_rhs")
        p = ctypes.c_void_p
        _cuda_build.bind(lib, "schur_s_rhs", [p] * 9 + [ctypes.c_int] * 3 + [p])
        lib.schur_s_rhs_max_cameras.argtypes = []
        lib.schur_s_rhs_max_cameras.restype = ctypes.c_int
        lib.schur_s_rhs_blocks.argtypes = [ctypes.c_int] * 3
        lib.schur_s_rhs_blocks.restype = ctypes.c_int
        lib.schur_s_rhs_partial_floats.argtypes = [ctypes.c_int]
        lib.schur_s_rhs_partial_floats.restype = ctypes.c_int
        if lib.schur_s_rhs_max_cameras() != MAX_CAMERAS:
            raise RuntimeError("schur_s_rhs library and wrapper disagree on the camera bound")
        _lib = lib
    return _lib


def _check_inputs(Jc, Jp, w, bp_t, lam):
    """Raise unless the kernel can take these inputs; returns (C, P)."""
    tensors = {"Jc": Jc, "Jp": Jp, "w": w, "bp_t": bp_t}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"schur_s_rhs: {name} must be a torch.Tensor, got {type(t).__name__}")
    device = Jc.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"schur_s_rhs: tensors must lie on the CPU or a CUDA device, not {device}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"schur_s_rhs: {name} is on {t.device} but Jc is on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"schur_s_rhs: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"schur_s_rhs: {name} must be contiguous")
    if Jc.ndim != 4 or Jc.shape[1:3] != (2, 9):
        raise ValueError(f"schur_s_rhs: Jc must be (C,2,9,P), got {tuple(Jc.shape)}")
    C, P = Jc.shape[0], Jc.shape[3]
    if not 1 <= C <= MAX_CAMERAS:
        raise ValueError(f"schur_s_rhs: the kernel takes 1..{MAX_CAMERAS} cameras, got {C}")
    if P < 1:
        raise ValueError("schur_s_rhs: needs at least one point")
    for name, t, shape in (("Jp", Jp, (C, 2, 3, P)), ("w", w, (C, 2, P)), ("bp_t", bp_t, (3, P))):
        if tuple(t.shape) != shape:
            raise ValueError(f"schur_s_rhs: {name} must be {shape}, got {tuple(t.shape)}")
    if isinstance(lam, torch.Tensor):
        if lam.numel() != 1 or lam.dtype != torch.float32 or lam.device != device:
            raise ValueError(f"schur_s_rhs: lam must be one float32 value on {device}")
    return C, P


def schur_s_rhs(Jc, Jp, w, bp_t, lam):
    """(S_raw, rhs_raw, Hpp_inv) through the CUDA kernel for CUDA tensors,
    through `schur_s_rhs_plain` for CPU tensors. `lam` is a float or a
    one-element float32 tensor on the inputs' device (read by the kernel on
    the device: no host synchronisation)."""
    C, P = _check_inputs(Jc, Jp, w, bp_t, lam)
    device = Jc.device
    if device.type == "cpu":
        return schur_s_rhs_plain(Jc, Jp, w, bp_t, lam)
    lib = _library()
    if not isinstance(lam, torch.Tensor):
        lam = torch.tensor(lam, dtype=torch.float32, device=device)
    lam = lam.reshape(1).contiguous()
    n_cp = 9 * C
    index = device.index if device.index is not None else torch.cuda.current_device()
    n_sm = _n_sm.get(index)
    if n_sm is None:
        n_sm = _n_sm[index] = torch.cuda.get_device_properties(index).multi_processor_count
    n_blocks = lib.schur_s_rhs_blocks(C, P, n_sm)  # blocks of pass 1
    partial = lib.schur_s_rhs_partial_floats(C)  # floats each writes for pass 2
    with torch.cuda.device(index):
        f32 = dict(dtype=torch.float32, device=device)
        S = torch.empty((n_cp, n_cp), **f32)
        rhs = torch.empty((n_cp,), **f32)
        hinv = torch.empty((3, 3, P), **f32)
        part = torch.empty((n_blocks, partial), **f32)  # pass 1's partial sums
        err = lib.schur_s_rhs_launch(
            Jc.data_ptr(), Jp.data_ptr(), w.data_ptr(), bp_t.data_ptr(), lam.data_ptr(),
            S.data_ptr(), rhs.data_ptr(), hinv.data_ptr(), part.data_ptr(),
            C, P, n_blocks, torch.cuda.current_stream(device).cuda_stream,
        )
    _cuda_build.check_launch(lib, "schur_s_rhs", err)
    _cuda_build.count_launch(schur_s_rhs, "launches")
    return S, rhs, hinv


schur_s_rhs.launches = 0  # kernel launches (CUDA inputs only) since import or the last reset


def fused_schur_available(problem, P: int, dtype) -> bool:
    """Whether the solver may assemble the Schur system with the kernel:
    a CUDA problem, reprojection-only (the constrained path's Schur factors
    double as a CG preconditioner that needs the explicit tensors), at most
    MAX_CAMERAS cameras, at least one point, float32."""
    return (
        problem.uv.device.type == "cuda"
        and problem.n_constraints == 0
        and 1 <= problem.n_cameras <= MAX_CAMERAS
        and P >= 1
        and dtype == torch.float32
    )
