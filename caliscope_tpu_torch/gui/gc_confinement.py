"""Cyclic-GC confinement for Qt native-binding thread safety.

Port of caliscope_tpu/gui/gc_confinement.py.

Parity: reference src/caliscope/gui/gc_confinement.py:1 (PYSIDE-810) —
shiboken wrappers around Qt C++ objects are not thread-safe under cyclic
GC traversal: a collection triggered from a worker thread can visit a
wrapper whose C++ object a render thread is using, a use-after-free.
The fix: disable automatic cyclic collection and run it periodically on
the GUI thread via a QTimer. Reference counting is untouched.

Under the headless backend this is inert but harmless (no native
wrappers), so callers don't need to branch on the backend — the same
confinement contract (gc.isenabled() False while active, periodic
main-thread collects) holds and is what the tests assert.
"""

from __future__ import annotations

import gc
import logging

from caliscope_tpu_torch.gui.qt import QTimer

logger = logging.getLogger(__name__)

DEFAULT_INTERVAL_MS = 10_000


def _collect() -> None:
    collected = gc.collect()
    if collected:
        logger.debug(f"GC collected {collected} objects")


def enable(interval_ms: int = DEFAULT_INTERVAL_MS) -> QTimer:
    """Disable automatic cyclic GC and return a started main-thread timer
    that runs collections instead. Call after QApplication creation and
    before any render-thread-backed widgets exist."""
    gc.disable()
    timer = QTimer()
    timer.timeout.connect(_collect)
    timer.start(interval_ms)
    logger.info(f"Cyclic GC confined to the GUI thread (every {interval_ms} ms)")
    return timer


def disable(timer: QTimer) -> None:
    """Stop the confinement timer and restore automatic cyclic GC."""
    timer.stop()
    gc.enable()
    gc.collect()
