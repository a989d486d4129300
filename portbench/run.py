#!/usr/bin/env python3
"""Run one cell of the benchmark of caliscope_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, on a machine with a
CUDA device. Set-up (imports, CUDA context, the kernels' builds through the
port's cache in caliscope_tpu_torch/_build/, the inputs made from the seed,
one warm job at the cell's shapes) counts as `setup_s`; then the window
runs for `--seconds`. With --trace 0 the last line of standard output is
the cell's end-to-end metrics; with --trace 1 its per-layer metrics, read
from portbench's spans and a torch.profiler stretch. Either way the
program's answers are then judged against the plain reference, and every
number compared is printed beside its limit, on standard error and under
the result's last key. The OpenMP and BLAS pools get one thread each,
so that the host's work keeps to the same cores from run to run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process with few threads: numpy's and torch's host pools of one
    # thread, set before either is imported
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # kernel and compiler caches at fixed places inside the checkout
    cache = ROOT / "portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    from portbench import harness

    cell = harness.Cell(args.workload, ROOT)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    if out is None:
        return 1
    print(json.dumps(out))
    return 0


def run_cell(cell, seed, seconds, trace, device, t_start):
    """Set up, run the window and judge one run of `cell` on `device`.
    Returns the result's object, or None (after saying why on standard
    error) when modules of JAX or the JAX package were loaded by the time
    the result is made: in the window, the readers or the judging."""
    import torch

    from portbench import harness

    limits = harness.load_json(cell.here / "workloads" / f"{cell.name}.json")["limits"]
    kind = cell.kind
    state = kind.setup(cell, seed, device)
    setup_s = time.perf_counter() - t_start

    rec = harness.Recorder()
    readers, targets = {}, {}
    if trace:
        for m in cell.per_layer:
            mod = cell.metric_module(m["name"])
            readers[m["name"]] = mod
            targets.update(getattr(mod, "SPANS", {}))
    with rec.wrapped(targets):
        res = kind.window(state, seconds, rec, trace)
    profile = res.get("profile")
    res["trace"] = harness.Trace(*profile, rec.spans) if profile else None
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0

    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = readers[m["name"]].read(res | {"rec": rec, "device_name": device_name})
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers = kind.judge(state, res, seed)
    checks = harness.judged(numbers, limits)
    for line in harness.checks_lines(checks):
        print(line, file=sys.stderr)
    correct = all(c["ok"] for c in checks.values()) and res["failed"] == 0

    device_info = {
        "platform": "gpu", "kind": device_name,
        "count": int(cell.entry["chips"]), "memory_peak_bytes": memory_peak,
    }
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"]}
    if trace:
        tr = res["trace"]
        device_info |= {"busy_s": tr.busy_s, "window_s": tr.window_s}
        out |= {"metrics": metrics, "device": device_info,
                "breakdown": {"device_ops": tr.top_kernels(10), "idle_gaps": tr.idle_gaps}}
    else:
        values = res["metrics"] | {"setup_s": setup_s}
        out |= {"metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end},
                "device": device_info}
    out["checks"] = {name: {"value": c["value"], "limit": c["limit"]} for name, c in checks.items()}
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return None
    return out


if __name__ == "__main__":
    sys.exit(main())
