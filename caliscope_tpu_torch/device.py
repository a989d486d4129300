"""Device and dtype resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    none is available — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "caliscope_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def resolve_dtype(device: torch.device, dtype=None) -> torch.dtype:
    """float32 on CUDA, float64 on the CPU, unless the caller names one."""
    if dtype is not None:
        return dtype
    return torch.float64 if device.type == "cpu" else torch.float32
