"""Framework exceptions with actionable messages.

Host-only copy of caliscope_tpu/exceptions.py (the port imports nothing
from the JAX package).
"""


class CalibrationError(Exception):
    """Raised when calibration cannot proceed; message says what to fix."""


class CalibrationWarning(UserWarning):
    """Non-fatal calibration quality concern."""


class PersistenceError(Exception):
    """Raised when an artifact cannot be read or written."""
