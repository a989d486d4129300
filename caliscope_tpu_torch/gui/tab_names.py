"""Central tab titles for the main window's tab bar.

Port of caliscope_tpu/gui/tab_names.py.

Tabs are addressed by title (MainWindow.tab_index); a misspelled title would
silently no-op setTabEnabled, so every load-bearing title lives in this enum
and a missed attribute fails loudly instead. Mirrors the reference's tab
flow (reference src/caliscope/gui/tab_names.py).
"""

from enum import Enum


class TabName(str, Enum):
    PROJECT = "Project"
    CAMERAS = "Cameras"
    INTRINSICS = "Intrinsics"
    EXTRACT = "Extract"
    EXTRINSICS = "Extrinsics"
    RECONSTRUCT = "Reconstruct"
    EXPLORER = "Explorer"

    def __str__(self) -> str:  # str(TabName.PROJECT) == "Project"
        return self.value
