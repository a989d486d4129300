"""Back-compat entry point: the GUI now lives in gui/main_window.py with
views/ and widgets/ (reference gui/main_widget.py architecture).

Port of caliscope_tpu/gui/app.py.
"""

from caliscope_tpu_torch.gui.main_window import MainWindow, run_app  # noqa: F401
