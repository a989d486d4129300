"""Build and load the port's CUDA kernels and library shims.

Each is one `csrc/<name>.cu` with a plain C interface. At first use it is
compiled with nvcc for sm_90a into a shared library under
`caliscope_tpu_torch/_build/` (named by a hash of the source and the flags,
link flags included, so a changed source is rebuilt and an unchanged one is
reused) and loaded with ctypes. A source that calls a CUDA library (the
nvJPEG shim; the window gather, which encodes its TMA tensor maps with
libcuda's cuTensorMapEncodeTiled) names it in LINK_FLAGS. nvcc is looked for under CUDA_HOME / CUDA_PATH, on PATH, and
under /usr/local/cuda. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("schur_s_rhs", "ccl", "corner_response", "extract_windows")
# every source under csrc/: the kernels and the shims over CUDA's libraries
SOURCES = KERNELS + ("nvjpeg_decode",)
LINK_FLAGS = {"nvjpeg_decode": ("-lnvjpeg",), "extract_windows": ("-lcuda",)}

# source name -> nvcc's output and the seconds of the build this process ran;
# "" and 0.0 for a library that was found already built
build_logs: dict[str, str] = {}
build_seconds: dict[str, float] = {}
_libs: dict[str, ctypes.CDLL] = {}
# One lock a kernel serialises its build and load, so threads that reach a
# kernel first at the same time build it once; other kernels build in
# parallel (build_all). `_locks_lock` guards the dictionary of locks, and
# `_count_lock` the launch counters of the kernels' wrappers.
_locks: dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()
_count_lock = threading.Lock()


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME); it is needed to build the kernels under csrc/")


def library_path(name: str) -> Path:
    source = source_path(name)
    flags = " ".join(NVCC_FLAGS + LINK_FLAGS.get(name, ()))
    digest = hashlib.sha256(source.read_bytes() + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _kernel_lock(name: str) -> threading.Lock:
    with _locks_lock:
        return _locks.setdefault(name, threading.Lock())


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library built from the same source
    and flags is already there. Returns the library's path."""
    with _kernel_lock(name):
        return _build_locked(name)


def _build_locked(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        # reused: this process ran no build of it (unless an earlier call did)
        build_seconds.setdefault(name, 0.0)
        build_logs.setdefault(name, "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name)), *LINK_FLAGS.get(name, ())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def build_all(names=SOURCES) -> dict[str, Path]:
    """Build several sources at once: one nvcc process each, all started
    together."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if need be. The
    caller sets argtypes and restypes of the functions it calls."""
    with _kernel_lock(name):
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_build_locked(name)))
        return _libs[name]


def count_launch(wrapper, *counters: str, n: int = 1) -> None:
    """Add n (one launch, or a CUDA graph's launches of the kernel per
    replay) to each named counter attribute of a kernel's wrapper
    (`launches` and the like), exactly under threads: the extraction runs
    one thread a camera through the same wrappers."""
    with _count_lock:
        for counter in counters:
            setattr(wrapper, counter, getattr(wrapper, counter) + n)


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch function of `lib` returned a CUDA error code.
    Every library exports `<name>_error_string(int) -> const char*`."""
    if err != 0:
        text = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {text} ({err})")


def bind(lib: ctypes.CDLL, name: str, launch_argtypes) -> None:
    """Declare the C signatures of `<name>_launch` and `<name>_error_string`."""
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = list(launch_argtypes)
    fn.restype = ctypes.c_int
    es = getattr(lib, f"{name}_error_string")
    es.argtypes = [ctypes.c_int]
    es.restype = ctypes.c_char_p
