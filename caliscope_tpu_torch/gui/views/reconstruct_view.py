"""Reconstruct tab: run a recording through tracking + triangulation,
preview the result, and list the exports.

Port of caliscope_tpu/gui/views/reconstruct_view.py.

Parity: reference gui/views/reconstruction_widget.py:40-487 —
- recording + TRACKER combos, the tracker list annotated with ONNX model
  availability (_refresh_tracker_combo_annotations:467) and gated through
  the model-download dialog when weights are missing
  (_selected_tracker_needs_download:254, _show_model_download_dialog:455);
- process-button text driven by the presenter state machine
  (_process_button_text_for_state:265, _update_ui_for_state:288);
- per-stage progress messages (_update_progress:370);
- post-run statistics + 3D visualization refresh from the written xyz
  CSV (_update_visualization:386-453, via PlaybackViewModel.from_xyz_csv);
- open-output affordance (_on_open_output_clicked:246).
"""

from __future__ import annotations

from pathlib import Path

from caliscope_tpu_torch.gui.bridge import SignalBridge
from caliscope_tpu_torch.gui.qt import (
    QComboBox,
    QHBoxLayout,
    QLabel,
    QProgressBar,
    QPushButton,
    QTableWidget,
    QTableWidgetItem,
    QVBoxLayout,
    QWidget,
)
from caliscope_tpu_torch.presenters.processing import ProcessingState


class ReconstructionView(QWidget):
    BUTTON_TEXT = {
        ProcessingState.IDLE: "Reconstruct",
        ProcessingState.PROCESSING: "Processing…",
        ProcessingState.COMPLETE: "Reconstruct again",
        ProcessingState.FAILED: "Retry",
    }

    def __init__(self, window, parent=None):
        super().__init__(parent)
        self.window = window
        layout = QVBoxLayout(self)
        row = QHBoxLayout()
        row.addWidget(QLabel("Recording:"))
        self.rec_box = QComboBox()
        self.rec_box.currentTextChanged.connect(lambda _t: self._list_exports())
        row.addWidget(self.rec_box)
        row.addWidget(QLabel("Tracker:"))
        self.tracker_box = QComboBox()
        row.addWidget(self.tracker_box)
        self.run_btn = QPushButton(self.BUTTON_TEXT[ProcessingState.IDLE])
        self.run_btn.clicked.connect(self.run)
        row.addWidget(self.run_btn)
        self.open_btn = QPushButton("Open output folder")
        self.open_btn.clicked.connect(self.open_output)
        row.addWidget(self.open_btn)
        layout.addLayout(row)
        self.progress = QProgressBar()
        layout.addWidget(self.progress)
        self.status = QLabel("")
        self.status.setWordWrap(True)
        layout.addWidget(self.status)
        self.stats = QLabel("")
        self.stats.setWordWrap(True)
        layout.addWidget(self.stats)
        self.exports_table = QTableWidget(0, 2)
        self.exports_table.setHorizontalHeaderLabels(["export", "size (kB)"])
        layout.addWidget(self.exports_table)
        self.preview = None  # Playback3DWidget, created on first result
        self._preview_slot = QVBoxLayout()
        layout.addLayout(self._preview_slot)
        layout.addStretch(1)
        self.bridge = SignalBridge(self.on_event)
        self.state = ProcessingState.IDLE
        self._cards = {}
        self.last_opened_path: Path | None = None

    # ---- population --------------------------------------------------------
    def refresh(self) -> None:
        ws = self.window.ws
        self.rec_box.clear()
        if ws:
            for name in ws.recording_names():
                self.rec_box.addItem(name)
            self._refresh_trackers(ws)
            self._list_exports()

    def _refresh_trackers(self, ws) -> None:
        """Workspace target tracker + discovered ONNX model cards, each
        annotated with weight availability (reference
        _refresh_tracker_combo_annotations:467)."""
        from caliscope_tpu_torch.pose.registry import scan_onnx_models

        current = self.tracker_box.currentText()
        self.tracker_box.clear()
        self.tracker_box.addItem(f"target ({ws.targets.get_extrinsic_tracker_name()})")
        cards_dir = Path(__file__).resolve().parents[2] / "pose" / "model_cards"
        self._cards = scan_onnx_models(cards_dir, ws.root / "models")
        for key, card in sorted(self._cards.items()):
            note = "" if card.model_path.exists() else "  (model not downloaded)"
            self.tracker_box.addItem(f"{key}{note}")
        if current and self.tracker_box.findText(current) >= 0:
            self.tracker_box.setCurrentText(current)

    def selected_tracker_key(self) -> str | None:
        """None = the workspace's extrinsic target tracker."""
        text = self.tracker_box.currentText()
        if not text or text.startswith("target ("):
            return None
        return text.split(" ")[0]

    def selected_tracker_needs_download(self) -> bool:
        key = self.selected_tracker_key()
        return key is not None and key in self._cards and not self._cards[key].model_path.exists()

    def _list_exports(self) -> None:
        ws = self.window.ws
        name = self.rec_box.currentText()
        if ws is None or not name:
            self.exports_table.setRowCount(0)
            return
        out_dir = ws.root / "recordings" / name
        files = sorted(
            p for p in out_dir.rglob("*") if p.is_file() and p.suffix in (".csv", ".trc", ".toml", ".py")
        )
        self.exports_table.setRowCount(len(files))
        for i, p in enumerate(files):
            self.exports_table.setItem(i, 0, QTableWidgetItem(str(p.relative_to(out_dir))))
            self.exports_table.setItem(i, 1, QTableWidgetItem(f"{p.stat().st_size / 1024:.1f}"))

    # ---- state machine ------------------------------------------------------
    def _set_state(self, state: ProcessingState) -> None:
        self.state = state
        self.run_btn.setText(self.BUTTON_TEXT[state])
        self.run_btn.setEnabled(state != ProcessingState.PROCESSING)

    def run(self) -> None:
        ws = self.window.ws
        name = self.rec_box.currentText()
        if ws is None or not name:
            return
        if self.selected_tracker_needs_download():
            self._show_download_dialog()
            return
        from caliscope_tpu_torch.tasks import TaskManager

        self._set_state(ProcessingState.PROCESSING)
        self.progress.setRange(0, 0)
        self.status.setText(f"Reconstructing {name}…")
        tm = getattr(self, "_tm", None) or TaskManager(max_workers=1)
        self._tm = tm
        key = self.selected_tracker_key()
        relay = self.bridge.relay

        class _Progress:
            """Per-stage progress relay (the api's PlainProgress protocol:
            on_frame's third argument is the POINT count, totals come from
            on_video_start), throttled so per-frame callbacks don't flood
            the event bridge."""

            def __init__(self):
                self._totals: dict[int, int] = {}

            # the api enters its progress as a context manager; the JAX
            # package's relay lacks these two, so its Reconstruct tab fails
            # with a TypeError before it extracts a frame
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def on_info(self, m):
                relay.emit("progress", (str(m), None))

            def on_video_start(self, c, total_frames):
                self._totals[c] = total_frames
                relay.emit("progress", (f"camera {c}: extracting {total_frames} frames", None))

            def on_frame(self, c, i, _n_points):
                total = self._totals.get(c, 0)
                if total and i % 30 == 0:
                    relay.emit("progress", (f"camera {c}: frame {i}/{total}", i / total))

            def on_video_complete(self, c):
                relay.emit("progress", (f"camera {c}: extraction done", None))

            def on_stage(self, p, m):
                relay.emit("progress", (str(m), p))

        def work():
            tracker = None
            if key is not None:
                from caliscope_tpu_torch.pose.registry import tracker_factory

                tracker = tracker_factory(key)(device=ws.device)
            ws.reconstruct_recording(name, tracker=tracker, progress=_Progress())
            return name

        handle = tm.submit(work, name="reconstruct")

        def on_done(fut):
            if fut.exception():
                self.bridge.relay.emit("error", (str(fut.exception()),))
            else:
                self.bridge.relay.emit("done", (fut.result(),))

        handle.future.add_done_callback(on_done)

    def on_event(self, name, args) -> None:
        if name == "progress":
            stage, frac = args
            self.status.setText(f"{stage}…" if frac is None else f"{stage}… {frac:.0%}")
            return
        self.progress.setRange(0, 1)
        self.progress.setValue(1)
        if name == "done":
            self._set_state(ProcessingState.COMPLETE)
            self.status.setText(f"Wrote exports for {args[0]}.")
            self._list_exports()
            self._update_visualization(args[0])
        else:
            self._set_state(ProcessingState.FAILED)
            self.status.setText(f"Error: {args[0]}")

    # ---- result preview -----------------------------------------------------
    def _update_visualization(self, name: str) -> None:
        """Load the written xyz CSV into the 3D playback preview + stats
        line (reference _update_visualization:386-453)."""
        ws = self.window.ws
        if ws is None:
            return
        import numpy as np

        from caliscope_tpu_torch.gui.view_models.playback_view_model import PlaybackViewModel
        from caliscope_tpu_torch.gui.widgets.playback_3d import Playback3DWidget

        out_dir = ws.root / "recordings" / name
        csvs = sorted(out_dir.rglob("xyz_*.csv"))
        csvs = [p for p in csvs if not p.stem.endswith("_labelled")]
        if not csvs:
            self.stats.setText("No xyz export found to preview.")
            return
        try:
            vm = PlaybackViewModel.from_xyz_csv(csvs[0], ws.cameras.load())
        except Exception as e:
            self.stats.setText(f"Preview unavailable: {e}")
            return
        if self.preview is None:
            self.preview = Playback3DWidget(width=480, height=320)
            self._preview_slot.addWidget(self.preview)
        self.preview.set_view_model(vm)
        n_frames = len(np.asarray(vm.valid_sync_indices))
        self.stats.setText(f"{csvs[0].name}: {n_frames} reconstructed frames.")

    def open_output(self) -> None:
        """Record (and under real Qt, open) the recording's output folder."""
        ws = self.window.ws
        name = self.rec_box.currentText()
        if ws is None or not name:
            return
        path = ws.root / "recordings" / name
        self.last_opened_path = path
        try:  # pragma: no cover - desktop integration, real sessions only
            from caliscope_tpu_torch.gui.qt import QDesktopServices, QUrl

            QDesktopServices.openUrl(QUrl.fromLocalFile(str(path)))
        except Exception:
            pass

    def _show_download_dialog(self) -> None:
        from caliscope_tpu_torch.gui.widgets.model_download import ModelDownloadDialog

        ws = self.window.ws
        dlg = ModelDownloadDialog(models_dir=ws.root / "models" if ws else None, parent=self)
        self._download_dialog = dlg
        if hasattr(dlg, "show"):
            dlg.show()
        self.status.setText("Selected tracker needs its model downloaded first.")
