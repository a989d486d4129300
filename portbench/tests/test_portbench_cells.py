"""Cells are data: a throwaway folder of BENCHMARK.json, configurations,
traffic mixes and limits drives the harness, a new cell and traffic mix
come as files alone, and each run's last line keeps the contract's shape."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT, run_tiny
from portbench import harness


def check_line(out, trace, cell):
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert isinstance(out["correct"], bool) and out["attempted"] > 0 and out["failed"] == 0
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and isinstance(dev["memory_peak_bytes"], int)
    want = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    assert set(out["metrics"]) <= set(units)
    if not trace:
        assert set(out["metrics"]) == set(units)
    for name, m in out["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("name", ["rig4_720p.track", "rig8_1080p.calibrate_truss", "rig4_720p.live",
                                  "rig8_1080p.calibrate"])
@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_runs_and_is_correct_on_the_cpu(tiny, name, trace):
    out = run_tiny(tiny, name, seconds=0.5, trace=trace)
    check_line(out, trace, harness.Cell(name, tiny, here=tiny))
    assert out["correct"], out["checks"]


def test_a_cell_added_as_files_alone(tiny):
    traffic = json.loads((tiny / "traffic" / "calibrate.json").read_text()) | {"what": "a copy under a name of its own"}
    (tiny / "traffic" / "calibrate_p5.json").write_text(json.dumps(traffic))
    limits = json.loads((tiny / "workloads" / "rig8_1080p.calibrate.json").read_text())
    (tiny / "workloads" / "rig8_1080p.calibrate_p5.json").write_text(json.dumps(limits))
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "rig8_1080p.calibrate_p5", "config": "rig8_1080p", "traffic": "calibrate_p5",
                               "chips": 1, "why": "a throwaway cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "calibrate_s":
            m["workloads"].append("rig8_1080p.calibrate_p5")
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell("rig8_1080p.calibrate_p5", tiny, here=tiny)
    assert cell.traffic["what"].startswith("a copy") and [m["name"] for m in cell.end_to_end] == ["calibrate_s", "setup_s"]
    out = run_tiny(tiny, "rig8_1080p.calibrate_p5", seconds=0.2)
    check_line(out, False, cell)
    assert out["correct"], out["checks"]


def test_the_command_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "rig4_720p.track", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=240,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_json_names_files_that_exist():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"], ROOT)
        assert (cell.here / "workloads" / f"{w['name']}.json").is_file()
        for m in cell.per_layer:
            assert hasattr(cell.metric_module(m["name"]), "read")


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the port on the card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "rig8_1080p.calibrate", "--seed",
                          str(2**31 + 3), "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"]


def test_live_latency_runs_from_each_frames_due_time(tiny):
    """Every frame due in the window is waited for and counted, and the
    latencies' tail, from each frame's due time, is read in the traced run."""
    out = run_tiny(tiny, "rig4_720p.live", seconds=1.0, trace=True)
    cell = harness.Cell("rig4_720p.live", tiny, here=tiny)
    assert out["attempted"] == int(1.0 * cell.traffic["fps"]) and out["failed"] == 0
    assert out["metrics"]["streamer.lag_p95_ms.live"]["value"] > 0
