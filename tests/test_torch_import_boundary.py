"""Import-boundary canaries for the PyTorch/CUDA port.

`import caliscope_tpu_torch` and every module of the package (the list is
derived from its files) must load
neither JAX nor anything of the JAX package (caliscope_tpu), nor triton,
nor a library the GPU machine does not have or is not known to have (cv2,
pandas, onnx, onnxruntime, PIL), and must not create a CUDA context; chip_smoke.py must import
none of JAX, the JAX package or bench.py. Each canary runs in a process of
its own (forked, one per module, from a subprocess that has imported torch
alone), so this file's own imports (the tests import both packages) cannot
leak into it.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

PACKAGE = ROOT / "caliscope_tpu_torch"

# Modules of the package that the canary cannot import on its own, with the
# reason. Every other module under caliscope_tpu_torch/ is checked.
NOT_IN_CANARY: dict[str, str] = {}


def _package_modules() -> list[str]:
    """Every module of the package, from its files (the build directory,
    which holds compiled kernels and no sources, is skipped)."""
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        if "_build" in rel.parts:
            continue
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return sorted(names)


SLICE_MODULES = [m for m in _package_modules() if m not in NOT_IN_CANARY]

CANARY = """
import json, os, sys, traceback
import torch
BAD = ('jax', 'jaxlib', 'triton', 'caliscope_tpu', 'cv2', 'pandas', 'onnx', 'onnxruntime', 'PIL')

def check(module):
    __import__(module)
    bad = sorted(m for m in sys.modules if m.split('.')[0] in BAD)
    assert not bad, f'import {module} pulled in {bad}'
    assert not torch.cuda.is_initialized(), f'import {module} created a CUDA context'
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == 'highest'

results = {}
for module in sys.argv[1:]:
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            check(module)
            code, msg = 0, ''
        except BaseException:
            code, msg = 1, traceback.format_exc()
        os.write(w, msg.encode())
        os._exit(code)
    os.close(w)
    with os.fdopen(r, 'rb') as f:
        msg = f.read().decode()
    _, status = os.waitpid(pid, 0)
    results[module] = [status, msg]
print(json.dumps(results))
"""


@pytest.fixture(scope="module")
def canaries():
    """module -> (wait status, traceback) of its canary: one subprocess
    imports torch alone, then forks a fresh child per module, which imports
    the module and checks what it loaded (one torch import for all of them,
    each module still alone in its own process)."""
    out = subprocess.run(
        [sys.executable, "-c", CANARY, *SLICE_MODULES], capture_output=True, text=True, timeout=900, cwd=ROOT,
    )
    assert out.returncode == 0, f"canary subprocess failed:\nstdout={out.stdout}\nstderr={out.stderr}"
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_module_list_covers_the_package():
    """The canary's list is the package's files: the modules every earlier
    slice added are in it, and nothing is left out without a reason."""
    modules = _package_modules()
    for name in ("caliscope_tpu_torch.constraints", "caliscope_tpu_torch.device", "caliscope_tpu_torch.exceptions",
                 "caliscope_tpu_torch.ops.bucket", "caliscope_tpu_torch.kernel_times",
                 "caliscope_tpu_torch.solvers.intrinsics", "caliscope_tpu_torch.trackers.chessboard_tracker",
                 "caliscope_tpu_torch.solvers.epipolar", "caliscope_tpu_torch.ops.signal",
                 "caliscope_tpu_torch.export", "caliscope_tpu_torch.export.trc", "caliscope_tpu_torch.export.blender",
                 "caliscope_tpu_torch.reconstruction", "caliscope_tpu_torch.pose", "caliscope_tpu_torch.pose.onnx_proto",
                 "caliscope_tpu_torch.pose.torch_onnx", "caliscope_tpu_torch.pose.rtmpose_arch",
                 "caliscope_tpu_torch.pose.onnx_torch", "caliscope_tpu_torch.pose.decode",
                 "caliscope_tpu_torch.pose.model_card", "caliscope_tpu_torch.pose.onnx_tracker",
                 "caliscope_tpu_torch.pose.registry", "caliscope_tpu_torch.pose.model_download",
                 "caliscope_tpu_torch.estimators", "caliscope_tpu_torch.estimators.vertical",
                 "caliscope_tpu_torch.estimators.vertical_solver", "caliscope_tpu_torch.estimators.geocalib_arch",
                 "caliscope_tpu_torch.parallel", "caliscope_tpu_torch.parallel.sharded",
                 "caliscope_tpu_torch.logger", "caliscope_tpu_torch.reporting", "caliscope_tpu_torch.media",
                 "caliscope_tpu_torch.media.video", "caliscope_tpu_torch.media.quicktime",
                 "caliscope_tpu_torch.media.frame_timestamps", "caliscope_tpu_torch.media.synchronized_timestamps",
                 "caliscope_tpu_torch.media.streamer", "caliscope_tpu_torch.tasks", "caliscope_tpu_torch.repositories",
                 "caliscope_tpu_torch.api", "caliscope_tpu_torch.pipelines.process_recording",
                 "caliscope_tpu_torch.workspace", "caliscope_tpu_torch.presenters",
                 "caliscope_tpu_torch.presenters.signal", "caliscope_tpu_torch.presenters.processing",
                 "caliscope_tpu_torch.presenters.intrinsic", "caliscope_tpu_torch.presenters.extrinsic",
                 "caliscope_tpu_torch.__main__", "caliscope_tpu_torch.synthetic.explorer", "caliscope_tpu_torch.detect.ring"):
        assert name in SLICE_MODULES
    assert set(SLICE_MODULES) | set(NOT_IN_CANARY) == set(modules)
    assert all(reason for reason in NOT_IN_CANARY.values())


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_port_module_imports_stay_torch_only(canaries, module):
    status, msg = canaries[module]
    assert status == 0 and not msg, f"canary of {module} failed (wait status {status}):\n{msg}"


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


def test_port_sources_import_no_library_the_gpu_machine_lacks():
    """No source of the port or chip_smoke.py imports cv2, pandas, onnx,
    onnxruntime or PIL, even lazily inside a function: the GPU machine has
    none of the first four and is not known to have PIL."""
    files = sorted((ROOT / "caliscope_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names
                          if n.split(".")[0] in ("cv2", "pandas", "onnx", "onnxruntime", "PIL")]
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
