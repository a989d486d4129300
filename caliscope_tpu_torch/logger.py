"""Logging setup: rotating file + console, global excepthook.

Port of caliscope_tpu/logger.py (reference src/caliscope/logger.py:69-113):
the package's loggers (`caliscope_tpu_torch.*`) go to stderr and, given a
directory, to a rotating `caliscope_tpu_torch.log` there.
"""

from __future__ import annotations

import logging
import logging.handlers
import sys
from pathlib import Path


def setup_logging(log_dir: Path | str | None = None, level: int = logging.INFO, console: bool = True) -> None:
    root = logging.getLogger("caliscope_tpu_torch")
    root.setLevel(level)
    for h in root.handlers:
        h.close()
    root.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)-7s %(name)s: %(message)s")
    if console:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        root.addHandler(h)
    if log_dir is not None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(log_dir / "caliscope_tpu_torch.log", maxBytes=2_000_000, backupCount=5)
        fh.setFormatter(fmt)
        root.addHandler(fh)

    def excepthook(exc_type, exc, tb):
        root.critical("Uncaught exception", exc_info=(exc_type, exc, tb))
        sys.__excepthook__(exc_type, exc, tb)

    sys.excepthook = excepthook
