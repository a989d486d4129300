"""Shared fixtures of portbench's own tests: a throwaway copy of the
benchmark's data in a temporary folder, cut to sizes the CPU runs in
seconds, driven through the harness with the device set to the CPU."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 2**31 + 12345  # seeds run past 32 signed bits


def tiny_folder(dest: Path) -> Path:
    """The benchmark's files in `dest`, the configurations cut to a CPU's
    sizes: 2 cameras at 320 x 192 and 6 frames for the tracker, 4 cameras
    and 24 frames for the calibration."""
    for sub in ("traffic", "workloads", "metrics"):
        shutil.copytree(HERE / sub, dest / sub)
    (dest / "configs").mkdir()
    r4 = json.loads((HERE / "configs" / "rig4_720p.json").read_text())
    r4["rig"].update(cameras=2, size=[320, 192], focal_px=450.0)
    r4["board"]["print_px_per_square"] = 42
    r4["session"].update(frames_per_camera_source=48, frames_per_camera=6)
    (dest / "configs" / "rig4_720p.json").write_text(json.dumps(r4))
    r8 = json.loads((HERE / "configs" / "rig8_1080p.json").read_text())
    r8["rig"]["cameras"] = 4
    r8["session"]["frames"] = 24
    (dest / "configs" / "rig8_1080p.json").write_text(json.dumps(r8))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        c["file"] = "configs/" + Path(c["file"]).name
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    for t in ("track", "live"):
        p = dest / "traffic" / f"{t}.json"
        d = json.loads(p.read_text())
        d.update(profile_frames=4, sample_calls=2, sample_count=2)
        if t == "live":
            d["warm_frames"] = 2
        p.write_text(json.dumps(d))
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return tiny_folder(tmp_path_factory.mktemp("portbench"))


def run_tiny(folder, name, seconds=0.5, trace=False, seed=SEED):
    """One run of cell `name` of the folder on the CPU: the result's object."""
    import torch

    from portbench import harness
    from portbench.run import run_cell

    cell = harness.Cell(name, folder, here=Path(folder))
    return run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
