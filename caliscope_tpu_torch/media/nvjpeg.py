"""Baseline JPEG decoding on the card: the wrapper of csrc/nvjpeg_decode.cu.

`NvJpegDecoder(device).decode(bitstreams)` decodes a batch of JPEG images
of one geometry into uint8 planes on the card (Y, or Y Cb Cr at the
images' own sampling), on torch's current stream. The shim is built with
nvcc at first use and linked against the toolkit's nvJPEG; it takes the
hardware backend (the card's JPEG engines) where nvJPEG offers it and its
GPU backend where it does not (`backend` says which). The plain version is
`media/jpeg.py`, which `media.video` uses for frames read on the CPU; an
nvJPEG error raises, never falls back to it.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from caliscope_tpu_torch import _cuda_build
from caliscope_tpu_torch.exceptions import CalibrationError

NAME = "nvjpeg_decode"
_lib = None
_lib_lock = threading.Lock()


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _cuda_build.load(NAME)
            p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            for fn, args in (
                ("create", [ctypes.POINTER(p), ctypes.POINTER(i)]),
                ("destroy", [p]),
                ("info", [p, p, z, ctypes.POINTER(i), p, p]),
                ("batch", [p, i, p, p, i, p, p, p]),
            ):
                f = getattr(lib, f"{NAME}_{fn}")
                f.argtypes, f.restype = args, i
            lib.nvjpeg_decode_error_string.argtypes = [i]
            lib.nvjpeg_decode_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(lib, what: str, err: int) -> None:
    if err:
        raise CalibrationError(f"nvJPEG {what} failed: {lib.nvjpeg_decode_error_string(err).decode()} ({err})")


class NvJpegDecoder:
    """One nvJPEG handle and state on a CUDA device; not shared between
    threads (each FrameSource makes its own)."""

    # decodes (not images) this process launched on the card; each adds one
    launches = 0

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"NvJpegDecoder decodes on a CUDA device, not {self.device}")
        self._lib = _library()
        handle, hardware = ctypes.c_void_p(), ctypes.c_int()
        with torch.cuda.device(self.device):
            _check(self._lib, "initialisation", self._lib.nvjpeg_decode_create(ctypes.byref(handle), ctypes.byref(hardware)))
        self._handle = handle
        # "hardware", or "gpu" with what the hardware backend answered
        self.backend = "hardware" if hardware.value == 0 else (
            f"gpu (the hardware backend: {self._lib.nvjpeg_decode_error_string(hardware.value).decode()})")

    def info(self, data: bytes) -> tuple[int, list[tuple[int, int]]]:
        """(components, [(height, width) of each component's plane])."""
        comps = ctypes.c_int()
        widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        _check(self._lib, "header parse", self._lib.nvjpeg_decode_info(
            self._handle, data, len(data), ctypes.byref(comps), widths, heights))
        return comps.value, [(heights[c], widths[c]) for c in range(comps.value)]

    def decode(self, bitstreams: list[bytes]) -> list[torch.Tensor]:
        """Decode JPEG images of one geometry. Returns one (n, h, w) uint8
        tensor a component on the card, once the decode has finished."""
        if not bitstreams:
            raise ValueError("no JPEG images to decode")
        n = len(bitstreams)
        comps, shapes = self.info(bitstreams[0])
        for data in bitstreams[1:]:
            if self.info(data) != (comps, shapes):
                raise CalibrationError("nvJPEG: the images of one batch differ in geometry")
        if comps not in (1, 3):
            raise CalibrationError(f"nvJPEG: a JPEG with {comps} components is not decoded (grey or YCbCr only)")
        planes = [torch.empty((n, h, w), dtype=torch.uint8, device=self.device) for h, w in shapes]
        ptrs = (ctypes.c_void_p * (n * comps))(*[planes[c][i].data_ptr() for i in range(n) for c in range(comps)])
        pitches = (ctypes.c_int * comps)(*[w for _, w in shapes])
        data = (ctypes.c_char_p * n)(*bitstreams)
        lengths = np.array([len(b) for b in bitstreams], np.uintp)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = self._lib.nvjpeg_decode_batch(self._handle, n, data, lengths.ctypes.data, comps, ptrs, pitches, stream)
        _check(self._lib, f"decode of {n} images", err)
        _cuda_build.count_launch(NvJpegDecoder, "launches")
        # nvJPEG may still read the host bitstreams: wait before they can go
        torch.cuda.current_stream(self.device).synchronize()
        return planes

    def close(self) -> None:
        if self._handle:
            with torch.cuda.device(self.device):
                self._lib.nvjpeg_decode_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the library may be gone
            pass
