"""Main window: welcome screen -> 6-tab project workspace.

Port of caliscope_tpu/gui/main_window.py.

Parity: reference gui/main_widget.py — welcome widget with recent projects,
menu bar (File: open / recent / exit), the Project / Intrinsics / Extract /
Extrinsics / Reconstruct / Explorer tab flow with per-status tab enabling, a docked
live log, filesystem watching (WorkspaceWatcher -> refresh), and graceful
teardown of background resources on close. The window opens its
workspace on its device (CUDA unless named; without CUDA an unnamed device
raises), and every tab runs its trackers and solvers there.

App settings (recent projects, newest last) persist in
~/.caliscope_tpu/settings.toml like the reference's APP_SETTINGS_PATH.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from caliscope_tpu_torch import persistence
from caliscope_tpu_torch.device import resolve_device
from caliscope_tpu_torch.gui.bridge import SignalBridge
from caliscope_tpu_torch.gui.qt import (
    QApplication,
    QFileDialog,
    QMainWindow,
    QTabWidget,
    QVBoxLayout,
    QWidget,
)
from caliscope_tpu_torch.gui.tab_names import TabName
from caliscope_tpu_torch.gui.views import (
    CamerasTabWidget,
    ExtractView,
    ExtrinsicCalibrationView,
    IntrinsicCalibrationView,
    ProjectSetupView,
    ReconstructionView,
)
from caliscope_tpu_torch.gui.widgets import LogDock, WelcomeWidget
from caliscope_tpu_torch.workspace import StepStatus, Workspace, WorkspaceWatcher

logger = logging.getLogger(__name__)

APP_SETTINGS_PATH = Path.home() / ".caliscope_tpu" / "settings.toml"


def load_app_settings(path: Path = APP_SETTINGS_PATH) -> dict:
    if path.exists():
        try:
            return persistence.load_toml(path)
        except Exception:
            logger.exception("Unreadable app settings; starting fresh")
    return {"recent_projects": []}


def save_app_settings(settings: dict, path: Path = APP_SETTINGS_PATH) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    persistence.safe_write_toml(settings, path)


class MainWindow(QMainWindow):
    def __init__(self, workspace_dir: Optional[Path] = None, settings_path: Optional[Path] = None, device=None):
        super().__init__()
        self.device = resolve_device(device)
        settings_path = APP_SETTINGS_PATH if settings_path is None else settings_path
        self.setWindowTitle("caliscope-tpu")
        self.resize(1100, 780)
        self.ws: Optional[Workspace] = None
        self.watcher: Optional[WorkspaceWatcher] = None
        self._settings_path = settings_path
        self.app_settings = load_app_settings(settings_path)
        self._watch_bridge = SignalBridge(lambda _n, _a: self.refresh_tabs())

        self._build_menus()
        self.show_welcome()
        if workspace_dir:
            self.launch_workspace(Path(workspace_dir))

    # ---- menus ---------------------------------------------------------------
    def _build_menus(self) -> None:
        file_menu = self.menuBar().addMenu("File")
        self.open_action = file_menu.addAction("Open / create project…")
        self.open_action.triggered.connect(self.open_project_dialog)
        self.recent_menu = file_menu.addMenu("Recent projects")
        self._rebuild_recent_menu()
        self.exit_action = file_menu.addAction("Exit")
        self.exit_action.triggered.connect(self._quit)
        tools_menu = self.menuBar().addMenu("Tools")
        self.models_action = tools_menu.addAction("Pose models…")
        self.models_action.triggered.connect(self.show_model_dialog)

    def _rebuild_recent_menu(self) -> None:
        # headless QMenu has no removeAction loop; rebuild is idempotent
        self.recent_menu._actions = [] if hasattr(self.recent_menu, "_actions") else self.recent_menu.actions()
        for p in self.recent_projects():
            a = self.recent_menu.addAction(p)
            a.triggered.connect(lambda path=p: self.launch_workspace(Path(path)))

    def show_model_dialog(self) -> None:
        from caliscope_tpu_torch.gui.widgets import ModelDownloadDialog

        self.model_dialog = ModelDownloadDialog()
        self.model_dialog.exec()

    def _quit(self) -> None:
        app = QApplication.instance()
        if app is not None:
            app.quit()

    # ---- recents ---------------------------------------------------------------
    def recent_projects(self) -> list[str]:
        """Newest-first recent project paths whose directories still exist."""
        return [p for p in reversed(self.app_settings.get("recent_projects", [])) if Path(p).is_dir()]

    def _remember_project(self, path: Path) -> None:
        recents = [p for p in self.app_settings.get("recent_projects", []) if p != str(path)]
        recents.append(str(path))
        self.app_settings["recent_projects"] = recents[-10:]
        save_app_settings(self.app_settings, self._settings_path)
        self._rebuild_recent_menu()

    # ---- welcome / workspace flow -----------------------------------------------
    def show_welcome(self) -> None:
        welcome = WelcomeWidget(self.recent_projects())
        welcome.open_project_requested.connect(self.open_project_dialog)
        welcome.recent_project_selected.connect(lambda p: self.launch_workspace(Path(p)))
        self.setCentralWidget(welcome)
        self.welcome = welcome

    def open_project_dialog(self) -> None:
        d = QFileDialog.getExistingDirectory(self, "Open or create a project directory")
        if d:
            self.launch_workspace(Path(d))

    def launch_workspace(self, path: Path) -> None:
        self._teardown_workspace()
        self.ws = Workspace.create(path, device=self.device)  # idempotent skeleton init
        self._remember_project(path)

        central = QWidget()
        layout = QVBoxLayout(central)
        self.tabs = QTabWidget()
        self.project_tab = ProjectSetupView(self)
        self.cameras_tab = CamerasTabWidget(self)
        self.intrinsic_tab = IntrinsicCalibrationView(self)
        self.extract_tab = ExtractView(self)
        self.extrinsic_tab = ExtrinsicCalibrationView(self)
        self.reconstruct_tab = ReconstructionView(self)
        from caliscope_tpu_torch.gui.views.explorer_view import ExplorerView

        self.explorer_tab = ExplorerView(device=self.device)
        for tab, name in [
            (self.project_tab, TabName.PROJECT),
            (self.cameras_tab, TabName.CAMERAS),
            (self.intrinsic_tab, TabName.INTRINSICS),
            (self.extract_tab, TabName.EXTRACT),
            (self.extrinsic_tab, TabName.EXTRINSICS),
            (self.reconstruct_tab, TabName.RECONSTRUCT),
            (self.explorer_tab, TabName.EXPLORER),
        ]:
            self.tabs.addTab(tab, str(name))
        layout.addWidget(self.tabs, 1)
        self.log = LogDock()
        self.log.setMaximumHeight(140)
        layout.addWidget(self.log)
        self.setCentralWidget(central)

        self.refresh_tabs()
        self.watcher = WorkspaceWatcher(self.ws, self._watch_bridge.forward("fs")).start()
        logger.info(f"Opened workspace {path}")

    def tab_index(self, name: TabName) -> int:
        for i in range(self.tabs.count()):
            if self.tabs.tabText(i) == str(name):
                return i
        return -1

    def refresh_tabs(self) -> None:
        """Recompute workflow gating + refresh every view from disk state."""
        if self.ws is None:
            return
        status = self.ws.get_workflow_status()
        # gating mirrors the reference tab flow: Extract needs intrinsics
        # underway, Extrinsics needs an extraction, Reconstruct a volume
        self.tabs.setTabEnabled(
            self.tab_index(TabName.EXTRACT), status.intrinsic_step_status is not StepStatus.NOT_STARTED
        )
        self.tabs.setTabEnabled(
            self.tab_index(TabName.EXTRINSICS), status.extrinsic_2d_step_status is StepStatus.COMPLETE
        )
        self.tabs.setTabEnabled(
            self.tab_index(TabName.RECONSTRUCT),
            status.extrinsic_calibration_step_status is StepStatus.COMPLETE,
        )
        for view in (self.project_tab, self.cameras_tab, self.intrinsic_tab, self.extract_tab, self.extrinsic_tab, self.reconstruct_tab):
            refresh = getattr(view, "refresh", None)
            if refresh:
                refresh()

    # ---- teardown ----------------------------------------------------------------
    def _teardown_workspace(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
            self.watcher = None
        cameras_tab = getattr(self, "cameras_tab", None)
        if cameras_tab is not None:
            cameras_tab.cleanup()
        log = getattr(self, "log", None)
        if log is not None:
            log.detach()

    def closeEvent(self, event) -> None:
        logger.info("Application exit initiated")
        self._teardown_workspace()
        super().closeEvent(event)


def run_app(workspace_dir=None, device=None) -> int:
    app = QApplication.instance() or QApplication([])
    win = MainWindow(Path(workspace_dir) if workspace_dir else None, device=device)
    win.show()
    return app.exec()
