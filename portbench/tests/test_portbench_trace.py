"""The metric arithmetic on a recorded profiler trace: device busy and idle
time, kernels by name, the idle gaps named by the host's operation, and the
rooflines from the frozen work counts."""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from conftest import HERE
from portbench import harness
from portbench.roofline import work

H100 = "NVIDIA H100 80GB HBM3"


@dataclass
class Event:
    name: str
    device_type: DeviceType
    start: float  # us
    end: float

    @property
    def time_range(self):
        return SimpleNamespace(start=self.start, end=self.end)


def recorded():
    """Kernels at [0, 10], [5, 20] (overlapping), [40, 50], a copy at [60,
    70]; host ops: `aten::item` over [20, 40], `cudaStreamSynchronize`
    inside it over [25, 35], and `host_loop` over [50, 60]."""
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [
        Event("ccl_resident(unsigned char const*, int*)", cuda, 0, 10),
        Event("corner_response_kernel(float const*, float*)", cuda, 5, 20),
        Event("ccl_resident(unsigned char const*, int*)", cuda, 40, 50),
        Event("Memcpy HtoD (Pageable -> Device)", cuda, 60, 70),
        Event("aten::item", cpu, 20, 40),
        Event("cudaStreamSynchronize", cpu, 25, 35),
        Event("host_loop", cpu, 50, 60),
    ]
    return SimpleNamespace(events=lambda: events)


def test_trace_busy_idle_kernels_and_gaps():
    tr = harness.Trace(recorded(), 100e-6, 0.0, [])
    assert tr.busy_s == pytest.approx(40e-6)  # [0, 20] + [40, 50] + [60, 70]
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.n_kernels == 3  # the copy is no kernel
    assert tr.kernels["ccl_resident(unsigned char const*, int*)"] == (2, pytest.approx(20e-6))
    assert tr.idle_gaps == [["cudaStreamSynchronize", pytest.approx(20e-6)], ["host_loop", pytest.approx(10e-6)]]
    assert tr.top_kernels(1)[0][0].startswith("ccl_resident")


def test_gap_named_by_the_innermost_span_where_no_host_op_covers_it():
    events = [e for e in recorded().events() if e.name != "host_loop"]
    prof = SimpleNamespace(events=lambda: events)
    spans = [("tracker.chunk", 1, 0.0, 1.0, None), ("media.read", 1, 20e-6, 70e-6, None)]
    tr = harness.Trace(prof, 100e-6, 0.0, spans)
    assert tr.idle_gaps[1][0] == "media.read"


def test_work_counts_and_roofline_share():
    assert work.RESPONSE_OPS_PER_PIXEL == 133
    assert work.ccl(8, 720, 1280, 4) == (8 * 720 * 1280 * 5, 8 * 720 * 1280 * 8, "fp32_flops_per_s")
    assert work.extract_windows(8, 64, 96)[0] == 8 * 64 * (2 * 4 * 96 * 96 + 8)
    b, ops, rate = work.corner_response(8, 720, 1280)
    least = work.least_seconds((b, ops, rate), H100)
    assert least == pytest.approx(max(b / 3.35e12, ops / 33.5e12))
    assert work.roofline_share([(b, ops, rate)] * 2, 4 * least, H100) == pytest.approx(50.0)
    assert work.roofline_share([], 1.0, H100) is None
    # the pipeline's Schur system: kernel 1's bound at C = 8, P = 24,576 is 6.89 us by its operations (PERF.md)
    assert work.least_seconds(work.schur_s_rhs(8, 24_576), H100) == pytest.approx(6.89e-6, rel=0.01)


def test_metric_readers_on_a_recorded_stretch():
    cell = SimpleNamespace(here=HERE)
    load = harness.Cell.metric_module.__get__(cell)
    tr = harness.Trace(recorded(), 100e-6, 0.0, [])
    shapes = [(8, 720, 1280), 4]
    rec = harness.Recorder()
    rec.spans = [("kernel.ccl", 1, 1.0, 1.1, shapes), ("kernel.ccl", 1, 9.0, 9.1, shapes)]
    record = {"trace": tr, "rec": rec, "stretch": (0.5, 2.0), "window": (0.0, 10.0), "profile_frames": 2,
              "device_name": H100}
    assert load("device.idle.track").read(record) == pytest.approx(60.0)
    assert load("device.kernels_per_frame.track").read(record) == pytest.approx(1.5)
    want = 100 * work.least_seconds(work.ccl(8, 720, 1280, 4), H100) / 20e-6  # one call in the stretch
    assert load("kernel.ccl_roofline").read(record) == pytest.approx(want)
    assert load("kernel.ccl_roofline").read(record | {"device_name": "cpu"}) is None
    assert load("device.idle.track").read(record | {"trace": None}) is None
