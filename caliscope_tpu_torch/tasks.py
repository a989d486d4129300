"""Cooperative cancellation + background task plumbing (headless).

Port of caliscope_tpu/tasks.py (host code).

Parity: reference src/caliscope/task_manager/ (CancellationToken
cancellation.py:6, TaskHandle task_handle.py:14, TaskManager task_manager.py:51).
The reference builds these on Qt signals/QThread; here the same contracts are
plain threading primitives so the calibration core carries no GUI dependency —
pipelines accept a token and a progress callback and stay framework-agnostic.
"""

from __future__ import annotations

import logging
import threading
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)


class CancellationToken:
    """Thread-safe cooperative cancellation flag, checked between pipeline
    stages (reference cancellation.py:6)."""

    def __init__(self) -> None:
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def is_cancelled(self) -> bool:
        return self._event.is_set()

    def raise_if_cancelled(self, message: str = "Operation cancelled") -> None:
        if self.is_cancelled:
            raise InterruptedError(message)


ProgressCallback = Callable[[int, str], None]


@dataclass
class TaskHandle:
    """Handle to a background task: progress observation, cancellation,
    result/exception retrieval (reference task_handle.py:14, sans Qt)."""

    name: str
    token: CancellationToken
    future: Future = field(repr=False)
    _progress: list[tuple[int, str]] = field(default_factory=list, repr=False)
    _progress_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    on_progress: Optional[ProgressCallback] = None

    def report_progress(self, pct: int, message: str) -> None:
        with self._progress_lock:
            self._progress.append((pct, message))
        if self.on_progress is not None:
            self.on_progress(pct, message)

    @property
    def progress_log(self) -> list[tuple[int, str]]:
        with self._progress_lock:
            return list(self._progress)

    def cancel(self) -> None:
        self.token.cancel()

    def result(self, timeout: float | None = None) -> Any:
        return self.future.result(timeout)

    @property
    def done(self) -> bool:
        return self.future.done()

    @property
    def cancelled(self) -> bool:
        return self.token.is_cancelled


class TaskManager:
    """Small thread-pool task runner for long calibrations behind a UI or
    notebook (reference task_manager.py:51 without QThread)."""

    def __init__(self, max_workers: int = 2):
        self._pool = ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="caliscope-task")
        self._tasks: list[TaskHandle] = []
        self._lock = threading.Lock()

    def submit(
        self,
        fn: Callable[..., Any],
        *args,
        name: str = "task",
        on_progress: Optional[ProgressCallback] = None,
        **kwargs,
    ) -> TaskHandle:
        """Run fn(*args, progress=..., cancellation_token=..., **kwargs) in the
        pool. fn may ignore the injected kwargs if it doesn't support them."""
        token = CancellationToken()
        placeholder: dict[str, TaskHandle] = {}

        def runner():
            handle = placeholder["handle"]
            try:
                import inspect

                sig = inspect.signature(fn)
                if "progress" in sig.parameters:
                    kwargs.setdefault("progress", handle.report_progress)
                if "cancellation_token" in sig.parameters:
                    kwargs.setdefault("cancellation_token", token)
                return fn(*args, **kwargs)
            except Exception:
                logger.error(f"Task {name} failed:\n{traceback.format_exc()}")
                raise

        future: Future = Future()

        def submit_and_chain():
            inner = self._pool.submit(runner)
            inner.add_done_callback(
                lambda f: future.set_exception(f.exception()) if f.exception() else future.set_result(f.result())
            )

        handle = TaskHandle(name=name, token=token, future=future, on_progress=on_progress)
        placeholder["handle"] = handle
        submit_and_chain()
        with self._lock:
            self._tasks.append(handle)
        return handle

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)
