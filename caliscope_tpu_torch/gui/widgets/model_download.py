"""Pose model manager dialog: card catalog + download/verify state.

Port of caliscope_tpu/gui/widgets/model_download.py.

Parity: reference gui/widgets/model_download_dialog.py — lists the shipped
model cards with size/license/availability, downloads missing weights on a
task thread (pose/model_download.py: fetch + sha256 verify + zip extract),
and reports per-card progress. Offline environments see accurate
"not downloaded" states and a clear error instead of a hang.
"""

from __future__ import annotations

from pathlib import Path

from caliscope_tpu_torch.gui.bridge import SignalBridge
from caliscope_tpu_torch.gui.qt import (
    QDialog,
    QLabel,
    QPushButton,
    QTableWidget,
    QTableWidgetItem,
    QVBoxLayout,
)
from caliscope_tpu_torch.pose.registry import scan_onnx_models

CARDS_DIR = Path(__file__).resolve().parents[2] / "pose" / "model_cards"


class ModelDownloadDialog(QDialog):
    def __init__(self, models_dir: Path | str | None = None, cards_dir: Path | str = CARDS_DIR, parent=None):
        super().__init__(parent)
        self.setWindowTitle("Pose models")
        self.models_dir = Path(models_dir) if models_dir else None
        layout = QVBoxLayout(self)
        self.table = QTableWidget(0, 5)
        self.table.setHorizontalHeaderLabels(["model", "keypoints", "size (MB)", "license", "status"])
        layout.addWidget(self.table)
        self.status = QLabel("")
        self.status.setWordWrap(True)
        layout.addWidget(self.status)
        self.download_btn = QPushButton("Download selected")
        self.download_btn.clicked.connect(self.download_selected)
        layout.addWidget(self.download_btn)
        close_btn = QPushButton("Close")
        close_btn.clicked.connect(self.accept)
        layout.addWidget(close_btn)

        self._bridge = SignalBridge(self._on_event)
        self.cards = scan_onnx_models(cards_dir, self.models_dir)
        self._keys: list[str] = []
        self.refresh()

    def refresh(self) -> None:
        self._keys = sorted(self.cards)
        self.table.setRowCount(len(self._keys))
        for i, key in enumerate(self._keys):
            card = self.cards[key]
            cells = [
                card.name,
                str(len(card.point_name_to_id)),
                f"{card.file_size_mb:.0f}" if card.file_size_mb else "?",
                card.license_info or "?",
                "downloaded" if card.onnx_exists else "not downloaded",
            ]
            for j, text in enumerate(cells):
                self.table.setItem(i, j, QTableWidgetItem(text))

    def download_selected(self) -> None:
        row = self.table.currentRow()
        if row < 0 or row >= len(self._keys):
            self.status.setText("Select a model row first.")
            return
        card = self.cards[self._keys[row]]
        if card.onnx_exists:
            self.status.setText(f"{card.name} is already downloaded.")
            return
        from caliscope_tpu_torch.tasks import TaskManager

        self.download_btn.setEnabled(False)
        self.status.setText(f"Downloading {card.name}…")
        tm = getattr(self, "_tm", None) or TaskManager(max_workers=1)
        self._tm = tm

        def work():
            from caliscope_tpu_torch.pose.model_download import ensure_model

            return ensure_model(card, progress=lambda pct, msg: self._bridge.relay.emit("progress", (pct, msg)))

        handle = tm.submit(work, name="model_download")

        def on_done(fut):
            if fut.exception():
                self._bridge.relay.emit("error", (str(fut.exception()),))
            else:
                self._bridge.relay.emit("done", (str(fut.result()),))

        handle.future.add_done_callback(on_done)

    def _on_event(self, name, args) -> None:
        if name == "progress":
            self.status.setText(f"Downloading… {args[0]}% ({args[1]})")
            return
        self.download_btn.setEnabled(True)
        if name == "done":
            self.status.setText(f"Saved {args[0]}.")
            self.refresh()
        else:
            self.status.setText(f"Download failed: {args[0]}")
