"""4-connected component labeling: the CUDA kernels' wrapper.

Port of caliscope_tpu/detect/pallas_ccl.py. `connected_components(mask,
n_iters)` labels a (B, H, W) bool mask: int32 linear pixel indices
(row * W + col), background H * W, the state after exactly `n_iters` rounds
of four directional segmented running-min scans, converged or not.

On a CUDA mask it launches a hand-written kernel of csrc/ccl.cu (built
with nvcc at first use, bound with ctypes). Which one is decided by the
frame's shape alone, in `resident_plan(H, W)`:

- a frame whose int32 label plane, with its flags, fits the shared memory of
  a thread-block cluster of 1, 2, 4, 8 or 16 blocks (227 KB each) and is at
  most 2,048 pixels wide takes the resident kernel: one launch, the frame
  on chip for all rounds (1280x720 is 16 blocks of 45 rows; anything up to
  about 930,000 pixels fits);
- any other frame (1920x1080, or wider than 2,048) takes two launches a
  round over labels in device memory, for any height and up to 14,528
  columns.

Neither path stands in for the other: a launch that the card refuses
raises. On a CPU mask, and only there, the wrapper computes the plain
version, detect/kernels.py::connected_components
(`connected_components_plain` here), which both kernels equal bit for bit
at the same `n_iters`. It raises on anything the kernels cannot take, on
either device.
"""

from __future__ import annotations

import ctypes

import torch

from caliscope_tpu_torch import _cuda_build
from caliscope_tpu_torch.detect.kernels import connected_components as connected_components_plain

# the two-launch path's shared-memory plans (csrc/ccl.cu): the widest frame
# its row pass takes (ccl_max_width), and the rows of a column strip it
# stages at once (ccl_max_segment_rows: a taller frame goes in segments)
MAX_WIDTH = 14528
MAX_SEGMENT_ROWS = 1760

# the resident path's plan (csrc/ccl.cu: SMEM_BYTES, RES_MAX_W, RES_CHUNK)
BLOCK_SHARED_BYTES = 232448
RESIDENT_MAX_WIDTH = 2048
RESIDENT_CHUNK = 256
CLUSTER_SIZES = (1, 2, 4, 8, 16)

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _cuda_build.load("ccl")
        p = ctypes.c_void_p
        _cuda_build.bind(lib, "ccl", [p, p] + [ctypes.c_int] * 4 + [p])
        lib.ccl_resident_launch.argtypes = [p, p] + [ctypes.c_int] * 6 + [p]
        lib.ccl_resident_launch.restype = ctypes.c_int
        lib.ccl_resident_bytes.argtypes = [ctypes.c_int] * 2
        lib.ccl_resident_bytes.restype = ctypes.c_longlong
        lib.ccl_resident_max_active_clusters.argtypes = [ctypes.c_int] * 3
        lib.ccl_resident_max_active_clusters.restype = ctypes.c_int
        lib.ccl_max_width.argtypes = []
        lib.ccl_max_width.restype = ctypes.c_int
        lib.ccl_max_segment_rows.argtypes = []
        lib.ccl_max_segment_rows.restype = ctypes.c_int
        if lib.ccl_max_width() != MAX_WIDTH or lib.ccl_max_segment_rows() != MAX_SEGMENT_ROWS:
            raise RuntimeError("ccl library and wrapper disagree on the two-launch path's plan")
        if lib.ccl_resident_bytes(45, 1280) != resident_bytes(45, 1280):
            raise RuntimeError("ccl library and wrapper disagree on the resident path's shared memory")
        _lib = lib
    return _lib


def resident_bytes(rows: int, W: int) -> int:
    """Shared memory one block of the resident path takes for `rows` rows:
    the labels, a flag per column and a flag per 256-pixel chunk of a row,
    each array padded to 4 bytes."""
    chunks = -(-W // RESIDENT_CHUNK)
    return 4 * rows * W + -(-W // 4) * 4 + -(-rows * chunks // 4) * 4


def resident_plan(H: int, W: int):
    """(blocks, rows_per_block) of the cluster that keeps an H x W frame on
    chip, or None if the frame takes the two-launch path. The smallest
    cluster whose blocks hold ceil(H / blocks) rows each; H need not divide
    (trailing blocks hold fewer rows, or none). A function of the shape
    only."""
    if W > RESIDENT_MAX_WIDTH:
        return None
    for blocks in CLUSTER_SIZES:
        rows = -(-H // blocks)
        if resident_bytes(rows, W) <= BLOCK_SHARED_BYTES:
            return blocks, rows
    return None


def resident_max_active_clusters(H: int, W: int) -> int:
    """How many of the frame's clusters the current CUDA device holds at
    once (cudaOccupancyMaxActiveClusters); raises if the query fails."""
    blocks, rows = resident_plan(H, W)
    lib = _library()
    n = lib.ccl_resident_max_active_clusters(blocks, rows, W)
    if n < 0:
        _cuda_build.check_launch(lib, "ccl", -n)
    return n


def _check_inputs(mask, n_iters):
    if not isinstance(mask, torch.Tensor):
        raise TypeError(f"connected_components: mask must be a torch.Tensor, got {type(mask).__name__}")
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
    # int32 labels: H * W pixel indices and the background value H * W
    if H * W + 1 >= 2**31:
        raise ValueError(f"connected_components: frame {H}x{W} has too many pixels for int32 labels")
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"connected_components: mask must lie on the CPU or a CUDA device, not {mask.device}")
    return B, H, W


def connected_components(mask, n_iters: int = 4):
    """(B, H, W) bool -> (B, H, W) int32 labels through a CUDA kernel for a
    CUDA mask (the resident one where `resident_plan(H, W)` gives a cluster,
    else the two-launch one), through `connected_components_plain` for a
    CPU mask."""
    B, H, W = _check_inputs(mask, n_iters)
    if mask.device.type == "cpu":
        return connected_components_plain(mask, n_iters)
    lib = _library()
    plan = resident_plan(H, W)
    with torch.cuda.device(mask.device):
        labels = torch.empty((B, H, W), dtype=torch.int32, device=mask.device)
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        if plan is None:
            err = lib.ccl_launch(mask.data_ptr(), labels.data_ptr(), B, H, W, n_iters, stream)
        else:
            err = lib.ccl_resident_launch(mask.data_ptr(), labels.data_ptr(), B, H, W, n_iters, *plan, stream)
    _cuda_build.check_launch(lib, "ccl", err)
    _cuda_build.count_launch(connected_components, "launches", *(("resident_launches",) if plan else ()))
    return labels


# wrapper calls that launched a kernel (CUDA inputs only) since import or the
# last reset: all of them, and those that took the resident path
connected_components.launches = 0
connected_components.resident_launches = 0
