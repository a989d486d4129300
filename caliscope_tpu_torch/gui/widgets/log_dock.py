"""Live log view fed by a logging.Handler (reference docked log widget).

Port of caliscope_tpu/gui/widgets/log_dock.py.
"""

from __future__ import annotations

import logging

from caliscope_tpu_torch.gui.bridge import SignalBridge
from caliscope_tpu_torch.gui.qt import QPlainTextEdit


class LogDock(QPlainTextEdit):
    def __init__(self, logger_name: str = "caliscope_tpu_torch", parent=None):
        super().__init__(parent)
        self.setReadOnly(True)
        self.setMaximumBlockCount(2000)
        self._bridge = SignalBridge(self._on_event)

        bridge = self._bridge

        class _Handler(logging.Handler):
            def emit(h, record):  # noqa: N805
                bridge.relay.emit("log", (h.format(record),))

        handler = _Handler()
        handler.setFormatter(logging.Formatter("%(levelname)s %(name)s: %(message)s"))
        handler.setLevel(logging.INFO)
        logging.getLogger(logger_name).addHandler(handler)
        self._handler = handler
        self._logger_name = logger_name

    def _on_event(self, _name, args):
        self.appendPlainText(args[0])

    def detach(self) -> None:
        logging.getLogger(self._logger_name).removeHandler(self._handler)
