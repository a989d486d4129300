"""The X-corner ring response and the window gather: CUDA kernels' wrappers
and their plain PyTorch versions.

Port of caliscope_tpu/detect/pallas_kernels.py.

`corner_response(images)`: (B, H, W) float32 -> (B, H, W) ChESS-style ring
response, 0 within 6 px of the border. It computes the reference KERNEL's
function, not its jnp twin's: the twin (corners.chess_corner_response
there) edge-pads and masks nothing, the kernel zeroes the border. The
plain version here masks as the kernel does.

`extract_windows(frames, yi, xi, win)`: one (win, win) window per seed from
(B, Hp, Wp) frames of float32 or int32; (yi, xi) are (B, K) int32 top-left
corners, clamped to [0, Hp - win] x [0, Wp - win] (as `lax.dynamic_slice`
clamps; the callers clip already, and clamping on the device costs no
synchronisation where a range check would). Returns (B, K, win, win) in the
input dtype, bit for bit.

On CUDA tensors the wrappers launch the hand-written kernels in
csrc/corner_response.cu and csrc/extract_windows.cu (built with nvcc at
first use, bound with ctypes); on CPU tensors, and only there, they compute
the plain versions. They raise on anything the kernels cannot take, on
either device.

The window gather has two paths in its kernel, both hand-written: TMA tile
loads and bulk stores where the frames allow them, and warp-per-row copies
for the rest. `tma_stages` picks one by shape and alignment;
`extract_windows.launches` counts every launch and
`extract_windows.tma_launches` the TMA path's.
Its wrapper does only the host work a launch needs: one quick test of its
inputs (`_fits`; the full checks, with their messages, run only when it
fails), the frames' device made current by the C launch and only if it is
not, and one packed argument block.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np
import torch

from caliscope_tpu_torch import _cuda_build
from caliscope_tpu_torch.detect.ring import N_TAPS, PAD, RADIUS

_libs: dict = {}


def _library(name: str):
    if name not in _libs:
        lib = _cuda_build.load(name)
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "corner_response":
            _cuda_build.bind(lib, name, [p, p, i, i, i, i, p])
            lib.corner_response_n_taps.argtypes = []
            lib.corner_response_n_taps.restype = i
            lib.corner_response_check_taps.argtypes = [p, p]
            lib.corner_response_check_taps.restype = i
            if lib.corner_response_n_taps() != N_TAPS:
                raise RuntimeError("corner_response library and wrapper disagree on the ring size")
            # the kernel's taps are compile-time constants: once, here, they
            # must be ring_taps() to the bit
            offsets, weights = ring_taps()
            bad = lib.corner_response_check_taps(offsets.ctypes.data, weights.ctypes.data)
            if bad:
                raise RuntimeError(f"corner_response library and wrapper disagree on tap {bad - 1}")
        else:
            _cuda_build.bind(lib, name, [ctypes.c_char_p])  # one packed ExtractWindowsArgs
        _libs[name] = lib
    return _libs[name]


def _check_tensor(fn: str, name: str, t, dtypes, ndim: int, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a torch.Tensor, got {type(t).__name__}")
    if device is None:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{fn}: {name} must lie on the CPU or a CUDA device, not {t.device}")
    elif t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device} but the frames are on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{fn}: {name} must be {' or '.join(str(d) for d in dtypes)}, got {t.dtype}")
    if t.ndim != ndim or min(t.shape) < 1:
        raise ValueError(f"{fn}: {name} must have {ndim} non-empty dimensions, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


# ---------------------------------------------------------------------------
# X-corner ring response
# ---------------------------------------------------------------------------


def ring_taps():
    """The ring's bilinear taps: (offsets (16, 2) int32 [iy, ix], weights
    (16, 4) float32 [1-fy, fy, 1-fx, fx]), floor/fraction split of the
    (dy, dx) ring offsets; the weights are rounded from float64 once, as a
    Python scalar times a float32 tensor rounds them."""
    from caliscope_tpu_torch.detect.corners import _ring_offsets

    offsets = np.empty((N_TAPS, 2), np.int32)
    weights = np.empty((N_TAPS, 4), np.float32)
    for k, (dx, dy) in enumerate(_ring_offsets(RADIUS, N_TAPS)):
        iy, ix = int(np.floor(dy)), int(np.floor(dx))
        fy, fx = float(dy - iy), float(dx - ix)
        offsets[k] = (iy, ix)
        weights[k] = (1 - fy, fy, 1 - fx, fx)
    return offsets, weights


def corner_response_plain(images):
    """The kernel's function in plain tensor operations, on any device: the
    same taps, the same order of float32 operations (rows blended first,
    then columns; sums left to right), the border zeroed."""
    B, H, W = images.shape
    offsets, weights = ring_taps()
    pad = PAD
    out = torch.zeros_like(images)
    Hi, Wi = H - 2 * pad, W - 2 * pad
    if Hi <= 0 or Wi <= 0:
        return out

    def shifted(dy, dx):
        return images[:, pad + dy : pad + dy + Hi, pad + dx : pad + dx + Wi]

    s = []
    for (iy, ix), (wy0, wy1, wx0, wx1) in zip(offsets.tolist(), weights.tolist()):
        r0 = wy0 * shifted(iy, ix) + wy1 * shifted(iy + 1, ix)
        r1 = wy0 * shifted(iy, ix + 1) + wy1 * shifted(iy + 1, ix + 1)
        s.append(wx0 * r0 + wx1 * r1)
    n = N_TAPS
    sr = sum(torch.abs(s[i] - s[i + n // 2]) for i in range(n // 2))
    dr = sum(torch.abs(s[i] - s[(i + n // 4) % n]) for i in range(n // 2))
    mean_ring = sum(s) / n
    mr = torch.abs(mean_ring - shifted(0, 0)) * (n // 2) * 0.5
    out[:, pad : H - pad, pad : W - pad] = torch.clamp(dr - sr - mr, min=0.0)
    return out


def corner_response(images):
    """(B, H, W) float32 -> (B, H, W) response through the CUDA kernel for
    CUDA frames, through `corner_response_plain` for CPU frames."""
    _check_tensor("corner_response", "images", images, (torch.float32,), 3)
    if images.device.type == "cpu":
        return corner_response_plain(images)
    lib = _library("corner_response")
    B, H, W = images.shape
    with torch.cuda.device(images.device):
        out = torch.empty_like(images)
        err = lib.corner_response_launch(
            images.data_ptr(), out.data_ptr(), B, H, W, PAD, torch.cuda.current_stream(images.device).cuda_stream
        )
    _cuda_build.check_launch(lib, "corner_response", err)
    _cuda_build.count_launch(corner_response, "launches")
    return out


corner_response.launches = 0  # kernel launches (CUDA inputs only) since import or the last reset


# ---------------------------------------------------------------------------
# Batched window extraction (subpixel corner windows, marker atlas patches)
# ---------------------------------------------------------------------------


def extract_windows_plain(frames, yi, xi, win: int):
    """One advanced-indexing gather, on any device: out[b, k, r, c] =
    frames[b, y + r, x + c] with the seeds clamped into the frame."""
    B, Hp, Wp = frames.shape
    ar = torch.arange(win, device=frames.device)
    y = yi.long().clamp(0, Hp - win)
    x = xi.long().clamp(0, Wp - win)
    b = torch.arange(B, device=frames.device)[:, None, None, None]
    return frames[b, y[:, :, None, None] + ar[:, None], x[:, :, None, None] + ar[None, :]]


# csrc/extract_windows.cu's TMA path: tile stages a block at most, the
# bytes its stages and packed window may take, their alignment, TMA's
# largest box side, the words a box row has beyond its window
TMA_MAX_STAGES = 2
TMA_RING_BYTES = 112 * 1024
TMA_STAGE_ALIGN = 128
TMA_MAX_BOX = 256
TMA_PAD = 4
# the C launch's ExtractWindowsArgs: frames, yi, xi, out, stream; B, Hp, Wp, K, win, stages, device
_ARGS = struct.Struct("=5Q7i4x")
_WORDS = (torch.float32, torch.int32)


def _aligned(nbytes: int) -> int:
    return -(-nbytes // TMA_STAGE_ALIGN) * TMA_STAGE_ALIGN


@functools.lru_cache(maxsize=None)
def _stages_of(Wp: int, win: int) -> int:
    box = win + TMA_PAD
    if Wp % 4 or win % 4 or box > min(Wp, TMA_MAX_BOX):
        return 0
    free = TMA_RING_BYTES - _aligned(4 * win * win)
    return max(0, min(TMA_MAX_STAGES, free // _aligned(4 * box * win)))


def tma_stages(Wp: int, win: int, address: int) -> int:
    """The tile stages of the window gather's TMA path for frames Wp words
    wide whose data start at byte `address`, and win x win windows; 0 where
    TMA cannot copy them and the rows path runs. TMA needs a row stride of a
    multiple of 16 bytes (Wp % 4 == 0), boxes that start on a 16-byte
    boundary with rows of a multiple of 16 bytes (win % 4 == 0, and a box
    TMA_PAD words wider than the window), box sides of at most 256 and
    within the frame, and a 16-byte aligned base; the kernel, a tile stage
    beside the packed window in TMA_RING_BYTES (win <= 116). A function of
    these three numbers only."""
    return 0 if address % 16 else _stages_of(Wp, win)


def windows_path(frames, win: int) -> str:
    """"tma" or "rows": the path of csrc/extract_windows.cu that `frames`
    (B, Hp, Wp) and win x win windows take."""
    return "tma" if tma_stages(frames.shape[2], win, frames.data_ptr()) else "rows"


def _check_windows(frames, yi, xi, win):
    fn = "extract_windows"
    _check_tensor(fn, "frames", frames, (torch.float32, torch.int32), 3)
    _check_tensor(fn, "yi", yi, (torch.int32,), 2, device=frames.device)
    _check_tensor(fn, "xi", xi, (torch.int32,), 2, device=frames.device)
    B, Hp, Wp = frames.shape
    if yi.shape[0] != B or xi.shape != yi.shape:
        raise ValueError(f"{fn}: yi and xi must both be ({B}, K), got {tuple(yi.shape)} and {tuple(xi.shape)}")
    if not isinstance(win, int) or not 1 <= win <= min(Hp, Wp):
        raise ValueError(f"{fn}: win must be an int in 1..{min(Hp, Wp)}, got {win!r}")
    return B, Hp, Wp, yi.shape[1]


def _fits(frames, yi, xi, win):
    """The wrapper's quick test of its inputs: (B, Hp, Wp, K), or None
    where `_check_windows` might refuse them (same device, types, shapes,
    contiguity and window size), so the full checks run only to name what
    is wrong."""
    try:
        B, Hp, Wp = frames.shape
        By, K = yi.shape
    except (AttributeError, TypeError, ValueError):
        return None
    if (
        frames.dtype in _WORDS and yi.dtype is torch.int32 and xi.dtype is torch.int32 and xi.shape == yi.shape
        and By == B and B > 0 and K > 0 and type(win) is int and 0 < win <= Hp and win <= Wp
        and frames.is_contiguous() and yi.is_contiguous() and xi.is_contiguous()
        and (frames.is_cuda or frames.is_cpu) and frames.device == yi.device == xi.device
    ):
        return B, Hp, Wp, K
    return None


def extract_windows(frames, yi, xi, win: int):
    """(B, Hp, Wp) float32/int32 frames, (B, K) int32 seeds -> (B, K, win,
    win) windows in the frames' dtype, through the CUDA kernel for CUDA
    tensors, through `extract_windows_plain` for CPU tensors."""
    shape = _fits(frames, yi, xi, win) if isinstance(frames, torch.Tensor) and frames.is_cuda else None
    if shape is None:
        shape = _check_windows(frames, yi, xi, win)
        if frames.device.type == "cpu":
            return extract_windows_plain(frames, yi, xi, win)
    B, Hp, Wp, K = shape
    lib = _libs.get("extract_windows") or _library("extract_windows")
    index = frames.get_device()
    out = frames.new_empty((B, K, win, win))
    address = frames.data_ptr()
    stages = tma_stages(Wp, win, address)
    err = lib.extract_windows_launch(_ARGS.pack(
        address, yi.data_ptr(), xi.data_ptr(), out.data_ptr(), torch._C._cuda_getCurrentRawStream(index),
        B, Hp, Wp, K, win, stages, index,
    ))
    if err:
        _cuda_build.check_launch(lib, "extract_windows", err)
    with _cuda_build._count_lock:  # exact under the extraction's threads
        extract_windows.launches += 1
        extract_windows.tma_launches += stages > 0
    return out


extract_windows.launches = 0  # kernel launches (CUDA inputs only) since import or the last reset
extract_windows.tma_launches = 0  # of them, on the TMA path
