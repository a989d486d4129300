"""Import-boundary canaries for the PyTorch/CUDA port.

`import caliscope_tpu_torch` and every module of the slice must load
neither JAX nor anything of the JAX package (caliscope_tpu), nor triton,
and must not create a CUDA context; chip_smoke.py must import none of JAX,
the JAX package or bench.py. Each canary runs in a subprocess so this
file's own imports (the tests import both packages) cannot leak into it.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

SLICE_MODULES = [
    "caliscope_tpu_torch",
    "caliscope_tpu_torch._cuda_build",
    "caliscope_tpu_torch.cameras",
    "caliscope_tpu_torch.convert",
    "caliscope_tpu_torch.detect.aruco",
    "caliscope_tpu_torch.detect.ccl",
    "caliscope_tpu_torch.detect.corners",
    "caliscope_tpu_torch.detect.cuda_kernels",
    "caliscope_tpu_torch.detect.dictionaries",
    "caliscope_tpu_torch.detect.kernels",
    "caliscope_tpu_torch.frame_selector",
    "caliscope_tpu_torch.observations",
    "caliscope_tpu_torch.ops.epipolar",
    "caliscope_tpu_torch.ops.lie",
    "caliscope_tpu_torch.ops.pnp",
    "caliscope_tpu_torch.ops.projection",
    "caliscope_tpu_torch.ops.reprojection",
    "caliscope_tpu_torch.ops.similarity",
    "caliscope_tpu_torch.ops.triangulate",
    "caliscope_tpu_torch.packets",
    "caliscope_tpu_torch.persistence",
    "caliscope_tpu_torch.pipelines",
    "caliscope_tpu_torch.pipelines.calibrate_extrinsics",
    "caliscope_tpu_torch.reports",
    "caliscope_tpu_torch.scale",
    "caliscope_tpu_torch.solvers.bundle",
    "caliscope_tpu_torch.solvers.fused_schur",
    "caliscope_tpu_torch.solvers.pose_network",
    "caliscope_tpu_torch.synthetic",
    "caliscope_tpu_torch.synthetic.calibration_object",
    "caliscope_tpu_torch.synthetic.camera_synthesizer",
    "caliscope_tpu_torch.synthetic.factories",
    "caliscope_tpu_torch.synthetic.faults",
    "caliscope_tpu_torch.synthetic.scene",
    "caliscope_tpu_torch.synthetic.se3",
    "caliscope_tpu_torch.synthetic.trajectory",
    "caliscope_tpu_torch.targets.charuco",
    "caliscope_tpu_torch.targets.render",
    "caliscope_tpu_torch.tasks",
    "caliscope_tpu_torch.tracker",
    "caliscope_tpu_torch.trackers.charuco_tracker",
    "caliscope_tpu_torch.volume",
]

CANARY = """
import sys
import {module}
import torch
bad = sorted(
    m for m in sys.modules
    if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'caliscope_tpu')
)
assert not bad, f'import {module} pulled in {{bad}}'
assert not torch.cuda.is_initialized(), 'import {module} created a CUDA context'
assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
assert torch.get_float32_matmul_precision() == 'highest'
"""


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_port_module_imports_stay_torch_only(module):
    out = subprocess.run(
        [sys.executable, "-c", CANARY.format(module=module)],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
    )
    assert out.returncode == 0, f"canary failed:\nstdout={out.stdout}\nstderr={out.stderr}"


def test_port_sources_name_no_jax():
    """No source of the port or chip_smoke.py imports jax, the JAX package
    or bench.py, even lazily inside a function."""
    files = sorted((ROOT / "caliscope_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "caliscope_tpu", "bench", "triton"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert not offenders, offenders


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a CUDA device, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=240)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
