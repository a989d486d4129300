#!/usr/bin/env python3
"""Time the hand-written kernels of a checkout of the port, GPU kernel by GPU
kernel, at the main paths' shapes.

    python3 caliscope_tpu_torch/kernel_times.py [--root CHECKOUT] [--label TEXT]

`--root` names the checkout whose `caliscope_tpu_torch` package is imported
(default: the one this file lies in), so that two versions of the kernels
can be timed in turns on one card: unpack the other commit somewhere
(`git archive`) and give its directory. Needs a CUDA device and nvcc; the
kernels are built at first use, as always.

For `schur_s_rhs` (C = 8, P = 40,960, float32), `connected_components`
((8, 720, 1280) bool at 45 % foreground, 4 rounds), `corner_response`
((8, 720, 1280) float32) and `extract_windows` at both callers' shapes (the
int32 patch atlas (8, 1356, 1280), K = 64, win = 96; the edge-padded float32
frames (8, 748, 1308), K = 256, win = 28), and at the one-frame shapes of
the ArUco and chessboard trackers (`connected_components` and
`corner_response` on (1, 720, 1280), `extract_windows` on (1, 748, 1308),
K = 512, win = 28: the chessboard's corner windows) it prints one JSON line
with the wrapper's time per call by CUDA events (median of 5 rounds of 20
warm calls), the host's time to issue a call (`host_ms`: perf_counter over 50
calls not waited for) and, from torch.profiler over 10 warm calls, the
device time per launch of every GPU kernel the wrapper launched, by kernel
name, with its launches per call (1 for each kernel here); for the window
gathers also the one-call PyTorch yardstick (`library_ms`: the advanced-
indexing gather on prebuilt indices, by CUDA events), the path the
checkout's kernel took (`path`, where its wrapper has `windows_path`), and
`host_steps_us`: what each host step of the checkout's window-gather
wrapper costs alone (see `window_host_steps`), and the rows path's device
time at the same shape (`rows_path_device_ms`); and what ptxas reported
for the kernels this process built (registers, spills).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
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


def host_ms(fn, reps=50):
    """The host's time to issue one call of `fn`: perf_counter over `reps`
    calls with no synchronisation between them (too few to fill the launch
    queue, so the host never waits for the device)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def _median_us(fn, reps=50, rounds=20):
    """Median over `rounds` of perf_counter's microseconds a call over `reps`
    calls of `fn`, the device synchronised between rounds (so a step that
    launches never waits for a full launch queue)."""
    import torch

    fn()
    samples = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        samples.append((time.perf_counter() - t0) * 1e6 / reps)
    torch.cuda.synchronize()
    return statistics.median(samples)


def window_host_steps(CK, frames, yi, xi, win):
    """Microseconds a call of each host step of the window-gather wrapper in
    module `CK` (a checkout's detect/cuda_kernels.py), each step timed alone
    (`_median_us`), and of the whole wrapper. The steps of the wrapper
    before its TMA path (three `_check_tensor` in `_check_windows`, the device context,
    `torch.empty`, `current_stream`, four `data_ptr`, the ctypes call with
    ten arguments, `check_launch`, `count_launch`), and the ones that took
    their place (`_fits`, `new_empty`, the raw stream, the packed
    arguments) where the module has them. The launches made here are taken
    back out of the wrapper's counters."""
    import torch

    from caliscope_tpu_torch import _cuda_build

    wrapper = CK.extract_windows
    counters = {name: getattr(wrapper, name) for name in ("launches", "tma_launches") if hasattr(wrapper, name)}
    lib = CK._library("extract_windows")
    B, Hp, Wp = frames.shape
    K = yi.shape[1]
    dev, index = frames.device, frames.get_device()
    out = torch.empty((B, K, win, win), dtype=frames.dtype, device=dev)
    ptrs = (frames.data_ptr(), yi.data_ptr(), xi.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream

    def context():
        with torch.cuda.device(dev):
            pass

    steps = {
        "check_windows": lambda: CK._check_windows(frames, yi, xi, win),
        "check_tensor": lambda: CK._check_tensor("extract_windows", "frames", frames, (torch.float32, torch.int32), 3),
        "device_context": context,
        "torch_empty": lambda: torch.empty((B, K, win, win), dtype=frames.dtype, device=dev),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "data_ptr_x4": lambda: (frames.data_ptr(), yi.data_ptr(), xi.data_ptr(), out.data_ptr()),
        "check_launch": lambda: _cuda_build.check_launch(lib, "extract_windows", 0),
        "count_launch": lambda: _cuda_build.count_launch(wrapper, "launches"),
        "new_empty": lambda: frames.new_empty((B, K, win, win)),
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "current_device": lambda: torch._C._cuda_getDevice(),
    }
    if hasattr(CK, "_ARGS"):
        stages = CK.tma_stages(Wp, win, ptrs[0])
        packed = CK._ARGS.pack(*ptrs, stream, B, Hp, Wp, K, win, stages, index)
        steps["fits"] = lambda: CK._fits(frames, yi, xi, win)
        steps["tma_stages"] = lambda: CK.tma_stages(Wp, win, ptrs[0])
        steps["pack_args"] = lambda: CK._ARGS.pack(*ptrs, stream, B, Hp, Wp, K, win, stages, index)
        steps["ctypes_launch"] = lambda: lib.extract_windows_launch(packed)
    else:
        steps["ctypes_launch"] = lambda: lib.extract_windows_launch(*ptrs, B, Hp, Wp, K, win, stream)
    steps["whole_wrapper"] = lambda: wrapper(frames, yi, xi, win)
    result = {name: _median_us(fn) for name, fn in steps.items()}
    for name, value in counters.items():
        setattr(wrapper, name, value)
    return result


def rows_path_device_ms(CK, frames, yi, xi, win):
    """Device ms a launch of the window gather's rows path at a shape its
    wrapper sends to the TMA path (the C launch called with stages 0), by
    torch.profiler: what the path rule weighs. None where the module has
    one path."""
    import torch

    if not hasattr(CK, "_ARGS"):
        return None
    lib = CK._library("extract_windows")
    B, Hp, Wp = frames.shape
    K = yi.shape[1]
    out = torch.empty((B, K, win, win), dtype=frames.dtype, device=frames.device)
    args = CK._ARGS.pack(frames.data_ptr(), yi.data_ptr(), xi.data_ptr(), out.data_ptr(),
                         torch.cuda.current_stream(frames.device).cuda_stream, B, Hp, Wp, K, win, 0, frames.get_device())

    def launch():
        err = lib.extract_windows_launch(args)
        if err:
            raise RuntimeError(f"extract_windows rows path: launch failed ({err})")

    launch()
    torch.cuda.synchronize()
    if not torch.equal(out, CK.extract_windows_plain(frames, yi, xi, win)):
        raise AssertionError("extract_windows rows path: differs from the plain version")
    return sum(rec["ms"] * rec["launches"] for rec in device_ms_by_kernel(launch).values())


def device_ms_by_kernel(fn, reps=10, tries=3):
    """Device ms per launch of every GPU kernel `fn` launches, by kernel
    name: the mean over the launches torch.profiler recorded in `reps`
    calls, with those launches per call. On the H100 the profiler now and
    then drops a short kernel's records (9 of 10, or none, recorded), so the
    mean is over what it kept, and a run that kept none is repeated."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "").split("(")[0]  # no namespace, no arguments
                us.setdefault(name, []).append(e.time_range.elapsed_us())
        out = {name: {"ms": sum(t) / len(t) / 1e3, "launches": len(t) / reps} for name, t in us.items()}
        if out:
            break
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
    from caliscope_tpu_torch.detect import cuda_kernels as CK
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
    frames = torch.from_numpy(rng.uniform(0, 255, size=(8, 720, 1280)).astype(np.float32)).to(dev)

    def window_args(src, K, win):
        B, Hp, Wp = src.shape
        seeds = [rng.integers(0, n - win + 1, size=(B, K)).astype(np.int32) for n in (Hp, Wp)]
        return (src, *(torch.from_numpy(a).to(dev) for a in seeds), win)

    def gather(src, yi, xi, win):
        """The one-call yardstick: frames[b, y + ar, x + ar] on prebuilt indices."""
        ar = torch.arange(win, device=dev)
        bi = torch.arange(src.shape[0], device=dev)[:, None, None, None]
        yy = yi.long()[:, :, None, None] + ar[:, None]
        xx = xi.long()[:, :, None, None] + ar[None, :]
        return lambda: src[bi, yy, xx]

    atlas = window_args(torch.from_numpy(rng.integers(0, 2**31 - 1, size=(8, 1356, 1280)).astype(np.int32)).to(dev), 64, 96)
    padded = window_args(torch.from_numpy(rng.uniform(0, 255, size=(8, 748, 1308)).astype(np.float32)).to(dev), 256, 28)
    chess = window_args(padded[0][:1].contiguous(), 512, 28)
    mask1, frame1 = mask[:1].contiguous(), frames[:1].contiguous()
    out = {"label": args.label, "package": str(Path(FS.__file__).resolve().parents[1]), "card": smi}
    for name, fn in (
        ("schur_s_rhs", lambda: FS.schur_s_rhs(*blocks)),
        ("connected_components", lambda: CCL.connected_components(mask, 4)),
        ("corner_response", lambda: CK.corner_response(frames)),
        ("extract_windows_atlas", lambda: CK.extract_windows(*atlas)),
        ("extract_windows_corners", lambda: CK.extract_windows(*padded)),
        ("connected_components_b1", lambda: CCL.connected_components(mask1, 4)),
        ("corner_response_b1", lambda: CK.corner_response(frame1)),
        ("extract_windows_chessboard_k512", lambda: CK.extract_windows(*chess)),
    ):
        out[name] = {"ms": event_ms(fn), "host_ms": host_ms(fn), "gpu_kernels": device_ms_by_kernel(fn)}
    for name, args_ in (("extract_windows_atlas", atlas), ("extract_windows_corners", padded), ("extract_windows_chessboard_k512", chess)):
        out[name]["library_ms"] = event_ms(gather(*args_))
        out[name]["host_steps_us"] = window_host_steps(CK, *args_)
        if hasattr(CK, "windows_path"):
            out[name]["path"] = CK.windows_path(args_[0], args_[3])
            out[name]["rows_path_device_ms"] = rows_path_device_ms(CK, *args_)
    from caliscope_tpu_torch import _cuda_build

    out["ptxas"] = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in _cuda_build.build_logs.items()
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
