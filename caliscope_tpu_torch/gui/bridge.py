"""Presenter-to-GUI-thread signal bridge.

Port of caliscope_tpu/gui/bridge.py.

Presenter signals (caliscope_tpu_torch/presenters/signal.py) fire on TaskManager
worker threads. Widgets must only be touched on the GUI thread, so every
presenter callback is funneled through ONE Qt signal carrying (name, args),
connected with QueuedConnection — Qt (or the headless event queue) then
delivers it on the GUI thread. This mirrors the reference's
per-presenter-signal Qt plumbing with a single seam instead of N.
"""

from __future__ import annotations

from caliscope_tpu_torch.gui.qt import QObject, Qt, Signal


class SignalBridge(QObject):
    relay = Signal(str, tuple)

    def __init__(self, handler=None):
        super().__init__()
        if handler is not None:
            self.relay.connect(handler, Qt.QueuedConnection)

    def forward(self, name: str):
        """A callable that re-emits its arguments as (name, args) queued."""

        def _fn(*args):
            self.relay.emit(name, args)

        return _fn

    def bind(self, presenter_signal, name: str) -> None:
        presenter_signal.connect(self.forward(name))
