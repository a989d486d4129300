"""GUI layer over the headless presenters (reference gui/, SURVEY §2.7).

Port of caliscope_tpu/gui/__init__.py. Every tab's trackers and solvers
run on the window's device: CUDA unless the caller names another (the
tests pass "cpu"), and without CUDA an unnamed device raises, as everywhere
in the port.

Architecture mirrors the reference's PySide6 MVP stack:

- main_window.py — welcome screen, recent projects, the Project /
  Intrinsics / Extract / Extrinsics / Reconstruct tab flow with workflow
  gating, docked live log, filesystem watching.
- views/ — one widget per tab, bound to the framework-agnostic presenters
  (caliscope_tpu_torch/presenters) through the SignalBridge (worker-thread
  callbacks delivered queued on the GUI thread).
- widgets/ — target config panels with live board preview, coverage
  heatmap, calibration-quality tabs (reprojection/rigidity/scale +
  sparkline), lens model visualizer, structural warnings, software-rendered
  3D capture-volume playback, workflow step strip, welcome screen.
- qt.py — backend selector: PySide6 when installed (offscreen-capable, the
  reference's own test strategy), else the pure-Python headless Qt in
  headless.py, which keeps every view constructible, drivable, and
  assertable in CI images without Qt wheels.
"""

from __future__ import annotations


def qt_available() -> bool:
    """True when real PySide6 backs the GUI (vs the headless fallback)."""
    try:
        import PySide6  # noqa: F401

        return True
    except ImportError:
        return False


def main(workspace_dir=None, device=None) -> int:
    """Launch the GUI (real Qt event loop, or the headless loop otherwise)
    on `device` (CUDA unless named)."""
    from caliscope_tpu_torch.gui.main_window import run_app

    return run_app(workspace_dir, device=device)
