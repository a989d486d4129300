"""4-connected component labeling: the CUDA kernel's wrapper.

Port of caliscope_tpu/detect/pallas_ccl.py. `connected_components(mask,
n_iters)` labels a (B, H, W) bool mask: int32 linear pixel indices
(row * W + col), background H * W, the state after exactly `n_iters` rounds
of four directional segmented running-min scans, converged or not.

On CUDA tensors it launches the hand-written kernel in csrc/ccl.cu (built
with nvcc at first use, bound with ctypes). On CPU tensors, and only there,
it computes the plain version, detect/kernels.py::connected_components
(`connected_components_plain` here), which the kernel equals bit for bit at
the same `n_iters`. It raises on anything the kernel cannot take, on
either device.
"""

from __future__ import annotations

import ctypes

import torch

from caliscope_tpu_torch import _cuda_build
from caliscope_tpu_torch.detect.kernels import connected_components as connected_components_plain

# the row pass's shared-memory plan (csrc/ccl.cu: ccl_max_width); any height
MAX_WIDTH = 14528

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _cuda_build.load("ccl")
        p = ctypes.c_void_p
        _cuda_build.bind(lib, "ccl", [p, p] + [ctypes.c_int] * 4 + [p])
        lib.ccl_max_width.argtypes = []
        lib.ccl_max_width.restype = ctypes.c_int
        if lib.ccl_max_width() != MAX_WIDTH:
            raise RuntimeError("ccl library and wrapper disagree on the widest frame")
        _lib = lib
    return _lib


def _check_inputs(mask, n_iters):
    if not isinstance(mask, torch.Tensor):
        raise TypeError(f"connected_components: mask must be a torch.Tensor, got {type(mask).__name__}")
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"connected_components: mask must lie on the CPU or a CUDA device, not {mask.device}")
    if mask.dtype != torch.bool:
        raise TypeError(f"connected_components: mask must be bool, got {mask.dtype}")
    if mask.ndim != 3 or min(mask.shape) < 1:
        raise ValueError(f"connected_components: mask must be (B,H,W) and non-empty, got {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("connected_components: mask must be contiguous")
    if not isinstance(n_iters, int) or n_iters < 0:
        raise ValueError(f"connected_components: n_iters must be a non-negative int, got {n_iters!r}")
    B, H, W = mask.shape
    if W > MAX_WIDTH:
        raise ValueError(f"connected_components: the kernel takes frames up to {MAX_WIDTH} columns, got {H}x{W}")
    # the plain version's int32 offset trick, which bounds both versions
    if (max(H, W) // 2 + 1) * (H * W + 1) >= 2**31:
        raise ValueError(f"connected_components: frame {H}x{W} overflows the int32 label arithmetic")
    return B, H, W


def connected_components(mask, n_iters: int = 4):
    """(B, H, W) bool -> (B, H, W) int32 labels through the CUDA kernel for
    a CUDA mask, through `connected_components_plain` for a CPU mask."""
    B, H, W = _check_inputs(mask, n_iters)
    if mask.device.type == "cpu":
        return connected_components_plain(mask, n_iters)
    lib = _library()
    with torch.cuda.device(mask.device):
        labels = torch.empty((B, H, W), dtype=torch.int32, device=mask.device)
        err = lib.ccl_launch(
            mask.data_ptr(), labels.data_ptr(), B, H, W, n_iters,
            torch.cuda.current_stream(mask.device).cuda_stream,
        )
    _cuda_build.check_launch(lib, "ccl", err)
    connected_components.launches += 1
    return labels


connected_components.launches = 0  # kernel launches (CUDA inputs only) since import or the last reset
