#!/usr/bin/env python3
"""Time the two largest hand-written kernels of a checkout of the port, GPU
kernel by GPU kernel, at the main paths' shapes.

    python3 caliscope_tpu_torch/kernel_times.py [--root CHECKOUT] [--label TEXT]

`--root` names the checkout whose `caliscope_tpu_torch` package is imported
(default: the one this file lies in), so that two versions of the kernels
can be timed in turns on one card: unpack the other commit somewhere
(`git archive`) and give its directory. Needs a CUDA device and nvcc; the
kernels are built at first use, as always.

For `schur_s_rhs` (C = 8, P = 40,960, float32) and `connected_components`
((8, 720, 1280) bool at 45 % foreground, 4 rounds) it prints one JSON line
with the wrapper's time per call by CUDA events (median of 5 rounds of 20
warm calls) and, from torch.profiler over 10 warm calls, the device time per
call of every GPU kernel the wrapper launched, by kernel name; and what
ptxas reported for the kernels this process built (registers, spills).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def event_ms(fn, reps=20, rounds=5):
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / reps)
    return statistics.median(samples)


def device_ms_by_kernel(fn, reps=10):
    """Device ms per call of `fn`, by GPU kernel name, and launches per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0]  # no namespace, no arguments
            rec = out.setdefault(name, {"ms": 0.0, "launches": 0.0})
            rec["ms"] += e.time_range.elapsed_us() / 1e3 / reps
            rec["launches"] += 1 / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from caliscope_tpu_torch.detect import ccl as CCL
    from caliscope_tpu_torch.solvers import fused_schur as FS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    C, P = 8, 40_960
    blocks = [
        torch.from_numpy(a.astype(np.float32)).to(dev)
        for a in (
            rng.normal(size=(C, 2, 9, P)) * 0.1, rng.normal(size=(C, 2, 3, P)) * 0.1,
            rng.uniform(0.5, 1.0, size=(C, 2, P)), rng.normal(size=(3, P)),
        )
    ] + [torch.tensor([1e-3], dtype=torch.float32, device=dev)]
    mask = torch.from_numpy(rng.uniform(size=(8, 720, 1280)) < 0.45).to(dev)
    out = {"label": args.label, "package": str(Path(FS.__file__).resolve().parents[1]), "card": smi}
    for name, fn in (
        ("schur_s_rhs", lambda: FS.schur_s_rhs(*blocks)),
        ("connected_components", lambda: CCL.connected_components(mask, 4)),
    ):
        out[name] = {"ms": event_ms(fn), "gpu_kernels": device_ms_by_kernel(fn)}
    from caliscope_tpu_torch import _cuda_build

    out["ptxas"] = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in _cuda_build.build_logs.items()
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
