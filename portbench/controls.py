#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the chip at
the cells' own sizes (the benchmark's own runs never run this).

    python3 portbench/controls.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For every seed in one process: the program's numbers (the lower readings),
from one job of the cell as its runs make it; for every control seed, the
control's numbers (the upper readings). In the calibrate cells the plain
reference judges in `WORKERS` processes of their own while the program's
next job runs on the card:
- track and live cells: the ring response's plain copy in bfloat16 against
  the program's sampled calls (kernel_mismatch), and the reference of the
  corners, their exact projections, rounded to bfloat16 and reported for
  every corner in the frame (the program's own lower-precision path, the
  tracker's 4-bit upload, moved the corners by 0.02-0.05 px only: its
  refinement runs on the 8-bit frames);
- calibrate cells: the plain reference in bfloat16 put in the program's
  place (reference/calibrate_check.py::control_answer), from the scene's
  observations; it runs on the host alone.
One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WORKERS = 6  # processes that judge readings while the program's next job runs (8 host cores)


def tracking_readings(cell, seed, device, control):
    """The judge's numbers of one job of a track or live cell, or the
    control's on the same job: the ring response's plain copy in bfloat16
    against the program's sampled calls, and the exact projections rounded
    to bfloat16 as the corners reported."""
    import torch

    from portbench import harness
    from portbench.reference import tracking_check

    kind = cell.kind
    state = kind.setup(cell, seed, device)
    seconds = 0.1 if cell.traffic["kind"] == "track" else 10.0
    res = kind.window(state, seconds, harness.Recorder(), False)
    if not control:
        return kind.judge(state, res, seed)
    mism = state["sampler"].mismatch(dtype=torch.bfloat16)
    state["tmp"].cleanup()
    truth, visible = state["truth"], state["visible"]
    return {"kernel_mismatch": float(sum(mism.values()))} | tracking_check.control_numbers(truth, visible)


def _judge_args(cell, seed):
    cfg, traffic = cell.config, cell.traffic
    scene = cell.kind.make_scene(cell, seed)
    return scene, traffic["constraints"] != "none", cfg["board"]["truss_sigma_m"], traffic["filter_percentile"]


def program_answer(cell, seed, device):
    """The program's answer of one job of a calibrate cell, as its runs make it."""
    from portbench import harness

    kind = cell.kind
    state = kind.setup(cell, seed, device)
    res = kind.window(state, 0.1, harness.Recorder(), False)
    job = res["jobs"][0]
    return kind.answer(job["run"], job["before"])


def control_numbers(cell, seed):
    from portbench.reference import calibrate_check as CC

    args = _judge_args(cell, seed)
    return CC.judge(CC.control_answer(*args, seed), *args, seed)


def _in_worker(name, seed, ans=None):
    """A reading judged in a worker process: the control's where `ans` is None."""
    from portbench import harness
    from portbench.reference import calibrate_check as CC

    cell = harness.Cell(name, ROOT)
    return control_numbers(cell, seed) if ans is None else CC.judge(ans, *_judge_args(cell, seed), seed)


def calibrate_readings(cell, seed, device, control):
    from portbench.reference import calibrate_check as CC

    if control:
        return control_numbers(cell, seed)
    return CC.judge(program_answer(cell, seed, device), *_judge_args(cell, seed), seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"  # as in run.py; the worker processes inherit it
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    cell = harness.Cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    if cell.traffic["kind"] == "calibrate":
        return calibrate_main(cell, args, device)
    for what, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t0 = time.perf_counter()
            nums = tracking_readings(cell, seed, device, what == "control")
            print(json.dumps({"workload": args.workload, "reading": what, "seed": seed, "numbers": nums,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def calibrate_main(cell, args, device):
    """The control seeds' readings and the program's judged in worker
    processes (spawned: they touch no CUDA), the program's jobs on the card
    one after another."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    t0 = time.perf_counter()
    pending = []
    with ProcessPoolExecutor(max_workers=WORKERS, mp_context=get_context("spawn")) as pool:
        for seed in [int(s) for s in args.control_seeds.split(",") if s]:
            pending.append(("control", seed, pool.submit(_in_worker, cell.name, seed)))
        for seed in [int(s) for s in args.seeds.split(",") if s]:
            ans = program_answer(cell, seed, device)
            pending.append(("program", seed, pool.submit(_in_worker, cell.name, seed, ans)))
        for what, seed, fut in pending:
            print(json.dumps({"workload": args.workload, "reading": what, "seed": seed, "numbers": fut.result(),
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
