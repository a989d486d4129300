"""Nothing a run loads is JAX or the JAX package, judged by whole top-level
module names; the plain references import nothing of the program."""

from __future__ import annotations

import subprocess
import sys

from conftest import ROOT, run_tiny
from portbench import harness


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    fake = dict.fromkeys(["caliscope_tpu_torch", "caliscope_tpu_torch.volume", "jaxtyping", "flaxen.x", "numpy"])
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    for bad, top in (("caliscope_tpu.solvers", "caliscope_tpu"), ("jax.numpy", "jax"), ("jaxlib", "jaxlib"),
                     ("flax.linen", "flax")):
        monkeypatch.setattr(sys, "modules", fake | {bad: None})
        assert harness.forbidden_modules() == [top]


def test_a_run_that_loads_jax_while_judging_prints_no_result(tiny, monkeypatch, capsys):
    """The look at sys.modules comes after the window, the readers and the
    judging, just before the result is made."""
    import types

    from portbench.kinds import calibrate

    original = calibrate.judge

    def judge(*args):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return original(*args)

    monkeypatch.setattr(calibrate, "judge", judge)
    assert run_tiny(tiny, "rig8_1080p.calibrate", seconds=0.2) is None
    assert "['jax']" in capsys.readouterr().err


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_a_runs_imports_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); import runpy, importlib\n"
            "from portbench import harness, run, controls\n"
            "for k in ('track', 'live', 'calibrate'): importlib.import_module('portbench.kinds.' + k)\n"
            "import caliscope_tpu_torch.api, caliscope_tpu_torch.pipelines, caliscope_tpu_torch.media.streamer\n"
            "print(' '.join(harness.forbidden_modules()) or 'none')")
    assert _loaded(code) == ["none"]


def test_the_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import portbench.reference.ba, portbench.reference.calibrate_check, portbench.reference.detect_plain\n"
            "import portbench.reference.tracking_check, portbench.roofline.work, portbench.gen.ring, portbench.gen.render\n"
            "import portbench.gen.quicktime\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules} & {'caliscope_tpu', 'caliscope_tpu_torch', 'jax'})) or 'none')")
    assert _loaded(code) == ["none"]
