"""Cooperative cancellation for the pipelines.

Host copy of `CancellationToken` from caliscope_tpu/tasks.py (the rest of
that module, the background task plumbing, is ROADMAP.md queue 1 item 25).
"""

from __future__ import annotations

import threading


class CancellationToken:
    """Thread-safe cooperative cancellation flag, checked between pipeline
    stages."""

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
