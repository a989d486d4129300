"""Repairs the host shell needed: it is the first caller of the trackers
from several threads (one a camera), and the CLI's export-board the first
caller of the board's PNG export on a machine without PIL.

- _cuda_build: eight threads that load the same kernel at once build it
  once (nvcc is stubbed: it copies a shared library after a pause) and get
  the same library; different kernels still build at the same time;
- launch counters: increments from many threads, with the interpreter
  switching threads every microsecond, come out exact, on each kernel
  wrapper's counters;
- the board's PNG, written with zlib and struct, decodes with PIL to the
  JAX package's image of the same board (plain and mirrored, through each
  package's CLI too).
"""

from __future__ import annotations

import ctypes.util
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from caliscope_tpu import __main__ as jax_cli
from caliscope_tpu.targets import Charuco as JaxCharuco

from caliscope_tpu_torch import __main__ as cli
from caliscope_tpu_torch import _cuda_build
from caliscope_tpu_torch.detect import ccl, cuda_kernels
from caliscope_tpu_torch.solvers import fused_schur
from caliscope_tpu_torch.targets import Charuco
from caliscope_tpu_torch.workspace import Workspace

PIL = pytest.importorskip("PIL.Image")


@pytest.fixture
def stub_nvcc(monkeypatch, tmp_path):
    """nvcc replaced by a copy of the C library after `delay` seconds; the
    builds land in a temporary directory. Yields the list of calls."""
    libc = ctypes.util.find_library("c")
    lib = next(p for p in (Path("/lib/x86_64-linux-gnu") / libc, Path("/usr/lib/x86_64-linux-gnu") / libc,
                           Path("/lib64") / libc, Path("/usr/lib64") / libc) if p.exists())
    calls, lock = [], threading.Lock()

    def fake_run(cmd, **kwargs):
        with lock:
            calls.append((time.perf_counter(), Path(cmd[-1]).stem))
        time.sleep(0.2)
        shutil.copy(lib, cmd[cmd.index("-o") + 1])
        return subprocess.CompletedProcess(cmd, 0, stdout="stub nvcc\n")

    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_cuda_build.subprocess, "run", fake_run)
    monkeypatch.setattr(_cuda_build, "_libs", {})
    monkeypatch.setattr(_cuda_build, "build_logs", {})
    monkeypatch.setattr(_cuda_build, "build_seconds", {})
    yield calls


def test_threads_loading_one_kernel_build_it_once(stub_nvcc):
    barrier = threading.Barrier(8)
    libs = []

    def worker():
        barrier.wait()
        libs.append(_cuda_build.load("ccl"))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(stub_nvcc) == 1 and len(libs) == 8 and all(lib is libs[0] for lib in libs)
    assert _cuda_build.library_path("ccl").exists()
    assert not list(_cuda_build.BUILD_DIR.glob(".*.tmp"))
    assert _cuda_build.load("ccl") is libs[0] and len(stub_nvcc) == 1


def test_different_kernels_still_build_together(stub_nvcc):
    t0 = time.perf_counter()
    paths = _cuda_build.build_all()
    assert sorted(paths) == sorted(_cuda_build.SOURCES) and all(p.exists() for p in paths.values())
    starts = sorted(t for t, _ in stub_nvcc)
    assert len(starts) == len(_cuda_build.SOURCES)
    assert starts[-1] - t0 < 0.15  # all started before the first (0.2 s) ended


def test_launch_counters_are_exact_under_threads():
    counted = [(cuda_kernels.corner_response, ("launches",)), (cuda_kernels.extract_windows, ("launches", "tma_launches")),
               (ccl.connected_components, ("launches", "resident_launches")), (fused_schur.schur_s_rhs, ("launches",))]
    saved = [(fn, name, getattr(fn, name)) for fn, names in counted for name in names]
    interval = sys.getswitchinterval()
    n_threads, n_each = 16, 500
    try:
        sys.setswitchinterval(1e-6)
        for fn, names in counted:
            for name in names:
                setattr(fn, name, 0)

        def worker():
            for _ in range(n_each):
                for fn, names in counted:
                    _cuda_build.count_launch(fn, *names)

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for fn, names in counted:
            assert all(getattr(fn, name) == n_threads * n_each for name in names), fn.__name__
    finally:
        sys.setswitchinterval(interval)
        for fn, name, value in saved:
            setattr(fn, name, value)


@pytest.mark.parametrize("mirror", [False, True])
def test_board_png_decodes_to_the_jax_packages(tmp_path, mirror):
    Charuco(rows=5, columns=7, square_size_m=0.054).save_image(tmp_path / "port.png", px_per_square=40, mirror=mirror)
    JaxCharuco(rows=5, columns=7, square_size_m=0.054).save_image(tmp_path / "jax.png", px_per_square=40, mirror=mirror)
    got, want = PIL.open(tmp_path / "port.png"), PIL.open(tmp_path / "jax.png")
    assert got.mode == want.mode == "L" and got.size == want.size
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_cli_export_board_matches_the_jax_cli(tmp_path):
    hook = sys.excepthook
    try:
        for main, name in ((cli.main, "port"), (jax_cli.main, "jax")):
            assert main(["init", str(tmp_path / name)]) == 0
            assert main(["export-board", str(tmp_path / name), str(tmp_path / f"{name}.png"), "--mirror",
                         "--px-per-square", "50"]) == 0
    finally:
        sys.excepthook = hook
        import logging

        for lg in ("caliscope_tpu_torch", "caliscope_tpu"):
            for h in logging.getLogger(lg).handlers:
                h.close()
            logging.getLogger(lg).handlers.clear()
    assert np.array_equal(np.asarray(PIL.open(tmp_path / "port.png")), np.asarray(PIL.open(tmp_path / "jax.png")))
    board = Workspace(tmp_path / "port").targets.load_intrinsic_charuco()
    assert np.array_equal(np.asarray(PIL.open(tmp_path / "port.png")), board.board_image(50)[:, ::-1])
