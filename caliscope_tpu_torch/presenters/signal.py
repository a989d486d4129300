"""Minimal observable signal (framework-agnostic Qt-Signal stand-in); port of
caliscope_tpu/presenters/signal.py."""

from __future__ import annotations

import logging
import threading
from typing import Callable

logger = logging.getLogger(__name__)


class Signal:
    """Thread-safe multicast callback; exceptions in one subscriber never
    break the others (matching Qt signal semantics closely enough for
    presenter logic)."""

    def __init__(self, name: str = "signal"):
        self._name = name
        self._subs: list[Callable] = []
        self._lock = threading.Lock()

    def connect(self, fn: Callable) -> None:
        with self._lock:
            self._subs.append(fn)

    def disconnect(self, fn: Callable) -> None:
        with self._lock:
            if fn in self._subs:
                self._subs.remove(fn)

    def emit(self, *args) -> None:
        with self._lock:
            subs = list(self._subs)
        for fn in subs:
            try:
                fn(*args)
            except Exception:
                logger.exception(f"Error in {self._name} subscriber")
