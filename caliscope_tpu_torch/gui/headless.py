"""Headless pure-Python implementation of the Qt subset the GUI uses.

Port of caliscope_tpu/gui/headless.py.

This is NOT a mock: it reproduces the Qt object model the views rely on —
signal/slot connections with direct vs queued delivery, a per-application
event queue pumped by processEvents()/exec(), widget parent trees, layout
containment, enable/visibility state, and the data models of the input
widgets (combo boxes, spin boxes, tables, tabs). GUI code written against
it runs unmodified under real PySide6 (see gui/qt.py for the selection).

Threading contract (mirrors Qt): signals emitted from the thread that
created the QApplication are delivered synchronously (DirectConnection);
emissions from any other thread are enqueued and delivered when the GUI
thread pumps events — exactly how Qt's AutoConnection resolves. This is
what lets presenter callbacks fire on TaskManager worker threads while
widget mutation stays on the GUI thread.

Rendering is the one thing intentionally absent: widgets keep their state
(text, pixmap arrays, table cells) introspectable for tests, but nothing
rasterizes. Image-producing widgets (coverage heatmap, 3D playback, lens
visualizer) render to numpy arrays via QImage, so their output is
assertable headlessly too.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Core object model: Qt namespace, signals, QObject, application event loop
# ---------------------------------------------------------------------------


class Qt:
    # connection types
    AutoConnection = 0
    DirectConnection = 1
    QueuedConnection = 2
    # orientations
    Horizontal = 1
    Vertical = 2
    # alignment (values irrelevant headlessly; distinct for identity checks)
    AlignLeft = 0x1
    AlignRight = 0x2
    AlignHCenter = 0x4
    AlignTop = 0x20
    AlignBottom = 0x40
    AlignVCenter = 0x80
    AlignCenter = 0x84
    # item flags / misc used by views
    ItemIsEnabled = 32
    ItemIsSelectable = 1
    SmoothTransformation = 1
    KeepAspectRatio = 1

    class ItemDataRole:
        UserRole = 256

    class Orientation:
        Horizontal = 1
        Vertical = 2

    class AlignmentFlag:
        AlignLeft = 0x1
        AlignRight = 0x2
        AlignHCenter = 0x4
        AlignCenter = 0x84


class _BoundSignal:
    def __init__(self, owner: "QObject", name: str):
        self._owner = owner
        self._name = name
        self._slots: list[tuple[Callable, int]] = []

    def connect(self, slot: Callable, conn_type: int = Qt.AutoConnection):
        self._slots.append((slot, conn_type))

    def disconnect(self, slot: Optional[Callable] = None):
        if slot is None:
            self._slots.clear()
        else:
            self._slots = [(s, t) for (s, t) in self._slots if s is not slot]

    def emit(self, *args):
        app = QApplication.instance()
        on_gui_thread = app is None or threading.current_thread() is app._thread
        for slot, conn_type in list(self._slots):
            queued = conn_type == Qt.QueuedConnection or (
                conn_type == Qt.AutoConnection and not on_gui_thread
            )
            if queued and app is not None:
                app._post(slot, args)
            else:
                slot(*args)


class Signal:
    """Class-attribute descriptor, bound per instance like Qt's Signal."""

    _counter = 0

    def __init__(self, *arg_types):
        self.arg_types = arg_types
        Signal._counter += 1
        self._attr = f"_signal_{Signal._counter}"

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        bound = obj.__dict__.get(self._attr)
        if bound is None:
            bound = _BoundSignal(obj, self._attr)
            obj.__dict__[self._attr] = bound
        return bound


class QObject:
    def __init__(self, parent: Optional["QObject"] = None):
        self._parent = parent
        self._object_name = ""

    def setObjectName(self, name: str):
        self._object_name = name

    def objectName(self) -> str:
        return self._object_name

    def parent(self):
        return self._parent

    def deleteLater(self):
        pass


class QApplication(QObject):
    _instance: Optional["QApplication"] = None

    def __init__(self, argv=None):
        super().__init__()
        if QApplication._instance is not None:
            raise RuntimeError("QApplication already exists")
        QApplication._instance = self
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._thread = threading.current_thread()
        self._quit = False

    @staticmethod
    def instance() -> Optional["QApplication"]:
        return QApplication._instance

    def _post(self, fn: Callable, args: tuple):
        with self._lock:
            self._queue.append((fn, args))

    def processEvents(self):
        while True:
            with self._lock:
                if not self._queue:
                    return
                fn, args = self._queue.popleft()
            fn(*args)

    def exec(self) -> int:
        # headless loop: pump until quit() — callers in tests use
        # processEvents() directly instead of exec()
        while not self._quit:
            self.processEvents()
            time.sleep(0.005)
        return 0

    def quit(self):
        self._quit = True

    @staticmethod
    def _reset_for_tests():
        QApplication._instance = None


class QTimer(QObject):
    timeout = Signal()

    def __init__(self, parent=None):
        super().__init__(parent)
        self._interval = 0
        self._active = False
        self._single = False

    def setInterval(self, ms: int):
        self._interval = ms

    def setSingleShot(self, yes: bool):
        self._single = yes

    def isActive(self) -> bool:
        return self._active

    def start(self, ms: Optional[int] = None):
        if ms is not None:
            self._interval = ms
        self._active = True
        app = QApplication.instance()
        if app is not None:
            # headless: fire on the next event pump (timers exist to defer
            # work off the current call stack, which this preserves)
            app._post(self._fire, ())

    def _fire(self):
        if not self._active:
            return
        if self._single:
            self._active = False
        self.timeout.emit()
        if self._active:
            app = QApplication.instance()
            if app is not None:
                app._post(self._fire, ())

    def stop(self):
        self._active = False

    @staticmethod
    def singleShot(ms: int, fn: Callable):
        app = QApplication.instance()
        if app is not None:
            app._post(fn, ())
        else:
            fn()


# ---------------------------------------------------------------------------
# Images (numpy-backed)
# ---------------------------------------------------------------------------


class QImage:
    Format_RGB888 = "rgb888"
    Format_Grayscale8 = "gray8"

    def __init__(self, data=None, width: int = 0, height: int = 0, bytes_per_line: int = 0, fmt: str = Format_RGB888):
        if data is None:
            self.array = np.zeros((height, width, 3), np.uint8)
        else:
            buf = np.frombuffer(bytes(data), np.uint8)
            if fmt == QImage.Format_Grayscale8:
                self.array = buf.reshape(height, bytes_per_line)[:, :width].copy()
            else:
                self.array = buf.reshape(height, bytes_per_line // 3, 3)[:, :width].copy()
        self._fmt = fmt

    def width(self) -> int:
        return self.array.shape[1]

    def height(self) -> int:
        return self.array.shape[0]


class QPixmap:
    def __init__(self, width: int = 0, height: int = 0):
        self.image: Optional[QImage] = QImage(width=width, height=height) if width else None

    @staticmethod
    def fromImage(img: QImage) -> "QPixmap":
        p = QPixmap()
        p.image = img
        return p

    def width(self) -> int:
        return self.image.width() if self.image else 0

    def height(self) -> int:
        return self.image.height() if self.image else 0

    def scaled(self, *a, **k) -> "QPixmap":
        return self

    def isNull(self) -> bool:
        return self.image is None


# ---------------------------------------------------------------------------
# Widgets
# ---------------------------------------------------------------------------


class QWidget(QObject):
    def __init__(self, parent: Optional["QWidget"] = None):
        super().__init__(parent)
        self._children: list[QWidget] = []
        if parent is not None:
            parent._children.append(self)
        self._layout: Optional[QLayout] = None
        self._enabled = True
        self._visible = False
        self._title = ""
        self._tooltip = ""
        self._size = (640, 480)
        self._minimum_size = (0, 0)
        self._maximum_height = 16777215
        self._style = ""

    # layout / tree
    def setLayout(self, layout: "QLayout"):
        self._layout = layout
        layout._reparent(self)

    def layout(self):
        return self._layout

    def children(self):
        return list(self._children)

    def findChildren(self, klass) -> list:
        out = []
        stack = list(self._children)
        while stack:
            w = stack.pop()
            if isinstance(w, klass):
                out.append(w)
            stack.extend(w._children)
        return out

    # state
    def setEnabled(self, yes: bool):
        self._enabled = bool(yes)

    def isEnabled(self) -> bool:
        return self._enabled

    def setVisible(self, yes: bool):
        self._visible = bool(yes)

    def isVisible(self) -> bool:
        return self._visible

    def show(self):
        self._visible = True

    def hide(self):
        self._visible = False

    def close(self):
        self._visible = False
        self.closeEvent(_CloseEvent())
        return True

    def closeEvent(self, event):
        event.accept()

    def setWindowTitle(self, t: str):
        self._title = t

    def windowTitle(self) -> str:
        return self._title

    def setToolTip(self, t: str):
        self._tooltip = t

    def toolTip(self) -> str:
        return self._tooltip

    def resize(self, w: int, h: int):
        self._size = (w, h)

    def setMinimumSize(self, w: int, h: int):
        self._minimum_size = (w, h)

    def setMinimumWidth(self, w: int):
        self._minimum_size = (w, self._minimum_size[1])

    def setMinimumHeight(self, h: int):
        self._minimum_size = (self._minimum_size[0], h)

    def setMaximumHeight(self, h: int):
        self._maximum_height = h

    def setMaximumWidth(self, w: int):
        pass

    def setFixedWidth(self, w: int):
        pass

    def setFixedHeight(self, h: int):
        pass

    def setStyleSheet(self, s: str):
        self._style = s

    def update(self):
        pass

    def repaint(self):
        pass

    def setFocus(self):
        pass

    def adjustSize(self):
        pass

    def sizeHint(self):
        return self._size

    def setContentsMargins(self, *a):
        pass

    def setWindowIcon(self, icon):
        pass

    def setCursor(self, c):
        pass


class _CloseEvent:
    def __init__(self):
        self.accepted = True

    def accept(self):
        self.accepted = True

    def ignore(self):
        self.accepted = False


class QLayout(QObject):
    def __init__(self, parent: Optional[QWidget] = None):
        super().__init__(parent)
        self._items: list[Any] = []
        self._widget: Optional[QWidget] = None
        if parent is not None:
            parent.setLayout(self)

    def _reparent(self, widget: QWidget):
        self._widget = widget
        for item in self._items:
            if isinstance(item, QWidget) and item._parent is None:
                item._parent = widget
                widget._children.append(item)

    def _adopt(self, w):
        if isinstance(w, QWidget) and self._widget is not None and w._parent is None:
            w._parent = self._widget
            self._widget._children.append(w)

    def addWidget(self, w: QWidget, *args, **kwargs):
        self._items.append(w)
        self._adopt(w)

    def insertWidget(self, i: int, w: QWidget, *args):
        self._items.insert(i, w)
        self._adopt(w)

    def addLayout(self, layout: "QLayout", *args):
        self._items.append(layout)
        if self._widget is not None:
            layout._reparent(self._widget)

    def addStretch(self, stretch: int = 0):
        self._items.append(("stretch", stretch))

    def addSpacing(self, s: int):
        self._items.append(("spacing", s))

    def count(self) -> int:
        return len(self._items)

    def itemAt(self, i: int):
        return self._items[i] if 0 <= i < len(self._items) else None

    def removeWidget(self, w: QWidget):
        self._items = [it for it in self._items if it is not w]

    def setContentsMargins(self, *a):
        pass

    def setSpacing(self, s: int):
        pass


class QVBoxLayout(QLayout):
    pass


class QHBoxLayout(QLayout):
    pass


class QGridLayout(QLayout):
    def addWidget(self, w: QWidget, row: int = 0, col: int = 0, *span, **kwargs):
        self._items.append(w)
        self._adopt(w)


class QFormLayout(QLayout):
    def addRow(self, label, widget=None):
        if widget is None:
            self._items.append(label)
            self._adopt(label)
        else:
            if isinstance(label, str):
                label = QLabel(label)
            self._items.append((label, widget))
            self._adopt(label)
            self._adopt(widget)


class QLabel(QWidget):
    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text
        self._pixmap: Optional[QPixmap] = None
        self._word_wrap = False
        self._alignment = None

    def setText(self, t: str):
        self._text = str(t)

    def text(self) -> str:
        return self._text

    def setWordWrap(self, yes: bool):
        self._word_wrap = bool(yes)

    def setPixmap(self, p: QPixmap):
        self._pixmap = p

    def pixmap(self) -> Optional[QPixmap]:
        return self._pixmap

    def setAlignment(self, a):
        self._alignment = a

    def setTextFormat(self, f):
        pass

    def setOpenExternalLinks(self, yes: bool):
        pass


class QPushButton(QWidget):
    clicked = Signal()

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text

    def setText(self, t: str):
        self._text = t

    def text(self) -> str:
        return self._text

    def click(self):
        if self._enabled:
            self.clicked.emit()

    def setDefault(self, yes: bool):
        pass


class QCheckBox(QWidget):
    toggled = Signal(bool)
    stateChanged = Signal(int)

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text
        self._checked = False

    def setChecked(self, yes: bool):
        yes = bool(yes)
        if yes != self._checked:
            self._checked = yes
            self.toggled.emit(yes)
            self.stateChanged.emit(2 if yes else 0)
        else:
            self._checked = yes

    def isChecked(self) -> bool:
        return self._checked

    def text(self) -> str:
        return self._text


class QComboBox(QWidget):
    currentIndexChanged = Signal(int)
    currentTextChanged = Signal(str)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._items: list[str] = []
        self._data: list[Any] = []
        self._index = -1

    def addItem(self, text: str, data: Any = None):
        self._items.append(str(text))
        self._data.append(data)
        if self._index < 0:
            self._set_index(0)

    def addItems(self, texts):
        for t in texts:
            self.addItem(t)

    def clear(self):
        self._items.clear()
        self._data.clear()
        self._index = -1

    def count(self) -> int:
        return len(self._items)

    def itemText(self, i: int) -> str:
        return self._items[i]

    def itemData(self, i: int) -> Any:
        return self._data[i]

    def currentText(self) -> str:
        return self._items[self._index] if 0 <= self._index < len(self._items) else ""

    def currentData(self) -> Any:
        return self._data[self._index] if 0 <= self._index < len(self._data) else None

    def currentIndex(self) -> int:
        return self._index

    def _set_index(self, i: int):
        if i != self._index:
            self._index = i
            self.currentIndexChanged.emit(i)
            self.currentTextChanged.emit(self.currentText())

    def setCurrentIndex(self, i: int):
        if 0 <= i < len(self._items):
            self._set_index(i)

    def setCurrentText(self, t: str):
        if t in self._items:
            self._set_index(self._items.index(t))

    def findText(self, t: str) -> int:
        return self._items.index(t) if t in self._items else -1


class _AbstractSpin(QWidget):
    valueChanged = Signal(object)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._min, self._max = 0.0, 99.0
        self._value = 0.0
        self._step = 1.0
        self._suffix = ""
        self._decimals = 2

    def setRange(self, lo, hi):
        self._min, self._max = lo, hi
        self._value = min(max(self._value, lo), hi)

    def setMinimum(self, lo):
        self.setRange(lo, self._max)

    def setMaximum(self, hi):
        self.setRange(self._min, hi)

    def minimum(self):
        return self._min

    def maximum(self):
        return self._max

    def setSingleStep(self, s):
        self._step = s

    def setSuffix(self, s: str):
        self._suffix = s

    def setDecimals(self, d: int):
        self._decimals = d

    def setValue(self, v):
        v = min(max(v, self._min), self._max)
        if v != self._value:
            self._value = v
            self.valueChanged.emit(self._coerce(v))
        else:
            self._value = v

    def _coerce(self, v):
        return v


class QDoubleSpinBox(_AbstractSpin):
    def value(self) -> float:
        return float(self._value)

    def _coerce(self, v):
        return float(v)


class QSpinBox(_AbstractSpin):
    def value(self) -> int:
        return int(self._value)

    def _coerce(self, v):
        return int(v)


class QSlider(QWidget):
    valueChanged = Signal(int)
    sliderReleased = Signal()

    def __init__(self, orientation=Qt.Horizontal, parent=None):
        super().__init__(parent)
        self._min, self._max = 0, 99
        self._value = 0

    def setRange(self, lo: int, hi: int):
        self._min, self._max = lo, hi
        self._value = min(max(self._value, lo), hi)

    def setMinimum(self, lo: int):
        self.setRange(lo, self._max)

    def setMaximum(self, hi: int):
        self.setRange(self._min, hi)

    def maximum(self) -> int:
        return self._max

    def minimum(self) -> int:
        return self._min

    def setValue(self, v: int):
        v = int(min(max(v, self._min), self._max))
        if v != self._value:
            self._value = v
            self.valueChanged.emit(v)
        else:
            self._value = v

    def value(self) -> int:
        return self._value

    def setTickInterval(self, i: int):
        pass

    def setTickPosition(self, p):
        pass

    TicksBelow = 2


class QProgressBar(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._min, self._max = 0, 100
        self._value = 0
        self._format = "%p%"

    def setRange(self, lo: int, hi: int):
        self._min, self._max = lo, hi

    def setMaximum(self, hi: int):
        self._max = hi

    def maximum(self) -> int:
        return self._max

    def setValue(self, v: int):
        self._value = v

    def value(self) -> int:
        return self._value

    def setFormat(self, f: str):
        self._format = f

    def setTextVisible(self, yes: bool):
        pass


class QPlainTextEdit(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._lines: deque = deque()
        self._max_blocks = 0
        self._read_only = False

    def setReadOnly(self, yes: bool):
        self._read_only = yes

    def setMaximumBlockCount(self, n: int):
        self._max_blocks = n

    def appendPlainText(self, t: str):
        self._lines.append(t)
        if self._max_blocks and len(self._lines) > self._max_blocks:
            self._lines.popleft()

    def setPlainText(self, t: str):
        self._lines = deque(t.splitlines())

    def toPlainText(self) -> str:
        return "\n".join(self._lines)

    def clear(self):
        self._lines.clear()


class QLineEdit(QWidget):
    textChanged = Signal(str)
    editingFinished = Signal()

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text
        self._placeholder = ""

    def setText(self, t: str):
        if t != self._text:
            self._text = t
            self.textChanged.emit(t)
        else:
            self._text = t

    def text(self) -> str:
        return self._text

    def setPlaceholderText(self, t: str):
        self._placeholder = t

    def setReadOnly(self, yes: bool):
        pass


class QTableWidgetItem:
    def __init__(self, text: str = ""):
        self._text = str(text)
        self._tooltip = ""
        self._data: dict[int, Any] = {}

    def text(self) -> str:
        return self._text

    def setText(self, t: str):
        self._text = str(t)

    def setToolTip(self, t: str):
        self._tooltip = t

    def setData(self, role: int, value: Any):
        self._data[role] = value

    def data(self, role: int) -> Any:
        return self._data.get(role)

    def setFlags(self, f):
        pass

    def setBackground(self, b):
        pass

    def setForeground(self, b):
        pass


class QTableWidget(QWidget):
    cellClicked = Signal(int, int)
    itemSelectionChanged = Signal()

    def __init__(self, rows: int = 0, cols: int = 0, parent=None):
        super().__init__(parent)
        self._rows, self._cols = rows, cols
        self._cells: dict[tuple[int, int], QTableWidgetItem] = {}
        self._headers: list[str] = []
        self._current_row = -1

    def setRowCount(self, n: int):
        self._rows = n
        self._cells = {k: v for k, v in self._cells.items() if k[0] < n}

    def setColumnCount(self, n: int):
        self._cols = n

    def rowCount(self) -> int:
        return self._rows

    def columnCount(self) -> int:
        return self._cols

    def setHorizontalHeaderLabels(self, labels):
        self._headers = list(labels)

    def setItem(self, r: int, c: int, item: QTableWidgetItem):
        self._cells[(r, c)] = item

    def item(self, r: int, c: int) -> Optional[QTableWidgetItem]:
        return self._cells.get((r, c))

    def clearContents(self):
        self._cells.clear()

    def currentRow(self) -> int:
        return self._current_row

    def setCurrentCell(self, r: int, c: int):
        self._current_row = r
        self.cellClicked.emit(r, c)

    def selectRow(self, r: int):
        self._current_row = r
        self.itemSelectionChanged.emit()

    def resizeColumnsToContents(self):
        pass

    def setSelectionBehavior(self, b):
        pass

    def setEditTriggers(self, t):
        pass

    def horizontalHeader(self):
        return _Header()

    def verticalHeader(self):
        return _Header()

    SelectRows = 1
    NoEditTriggers = 0


class _Header:
    def setStretchLastSection(self, yes: bool):
        pass

    def setSectionResizeMode(self, *a):
        pass

    def setVisible(self, yes: bool):
        pass


class QTabWidget(QWidget):
    currentChanged = Signal(int)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._tabs: list[tuple[QWidget, str]] = []
        self._enabled_tabs: dict[int, bool] = {}
        self._index = -1

    def addTab(self, w: QWidget, title: str) -> int:
        self._tabs.append((w, title))
        w._parent = self
        self._children.append(w)
        if self._index < 0:
            self._index = 0
        return len(self._tabs) - 1

    def count(self) -> int:
        return len(self._tabs)

    def widget(self, i: int) -> Optional[QWidget]:
        return self._tabs[i][0] if 0 <= i < len(self._tabs) else None

    def tabText(self, i: int) -> str:
        return self._tabs[i][1] if 0 <= i < len(self._tabs) else ""

    def indexOf(self, w: QWidget) -> int:
        for i, (tw, _) in enumerate(self._tabs):
            if tw is w:
                return i
        return -1

    def setTabEnabled(self, i: int, yes: bool):
        if 0 <= i < len(self._tabs):  # Qt silently ignores -1
            self._enabled_tabs[i] = bool(yes)

    def isTabEnabled(self, i: int) -> bool:
        return self._enabled_tabs.get(i, True)

    def setCurrentIndex(self, i: int):
        if 0 <= i < len(self._tabs) and i != self._index:
            self._index = i
            self.currentChanged.emit(i)

    def setCurrentWidget(self, w: QWidget):
        self.setCurrentIndex(self.indexOf(w))

    def currentIndex(self) -> int:
        return self._index

    def currentWidget(self) -> Optional[QWidget]:
        return self.widget(self._index)

    def clear(self):
        self._tabs.clear()
        self._index = -1


class QGroupBox(QWidget):
    def __init__(self, title: str = "", parent=None):
        super().__init__(parent)
        self._title = title

    def title(self) -> str:
        return self._title


class QSplitter(QWidget):
    def __init__(self, orientation=Qt.Horizontal, parent=None):
        super().__init__(parent)
        self._widgets: list[QWidget] = []

    def addWidget(self, w: QWidget):
        self._widgets.append(w)
        w._parent = self
        self._children.append(w)

    def setSizes(self, sizes):
        pass

    def setStretchFactor(self, i: int, f: int):
        pass


class QScrollArea(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._widget: Optional[QWidget] = None

    def setWidget(self, w: QWidget):
        self._widget = w
        w._parent = self
        self._children.append(w)

    def widget(self):
        return self._widget

    def setWidgetResizable(self, yes: bool):
        pass


class QAction(QObject):
    triggered = Signal()

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text

    def text(self) -> str:
        return self._text

    def trigger(self):
        self.triggered.emit()

    def setShortcut(self, s):
        pass

    def setEnabled(self, yes: bool):
        pass


class QMenu(QObject):
    def __init__(self, title: str = "", parent=None):
        super().__init__(parent)
        self._title = title
        self._actions: list[QAction] = []

    def addAction(self, action_or_text, parent=None) -> QAction:
        if isinstance(action_or_text, QAction):
            a = action_or_text
        else:
            a = QAction(str(action_or_text))
        self._actions.append(a)
        return a

    def addMenu(self, menu_or_title) -> "QMenu":
        m = menu_or_title if isinstance(menu_or_title, QMenu) else QMenu(str(menu_or_title))
        self._actions.append(m)
        return m

    def actions(self):
        return list(self._actions)

    def addSeparator(self):
        pass


class _MenuBar(QMenu):
    pass


class _StatusBar(QWidget):
    def __init__(self):
        super().__init__()
        self._message = ""

    def showMessage(self, m: str, timeout: int = 0):
        self._message = m

    def currentMessage(self) -> str:
        return self._message


class QMainWindow(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._central: Optional[QWidget] = None
        self._menu_bar = _MenuBar()
        self._status_bar = _StatusBar()
        self._docks: list[QWidget] = []

    def setCentralWidget(self, w: QWidget):
        self._central = w
        w._parent = self
        self._children.append(w)

    def centralWidget(self) -> Optional[QWidget]:
        return self._central

    def menuBar(self) -> _MenuBar:
        return self._menu_bar

    def statusBar(self) -> _StatusBar:
        return self._status_bar

    def addDockWidget(self, area, dock):
        self._docks.append(dock)


class QDialog(QWidget):
    Accepted = 1
    Rejected = 0
    finished = Signal(int)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._result = QDialog.Rejected

    def accept(self):
        self._result = QDialog.Accepted
        self._visible = False
        self.finished.emit(self._result)

    def reject(self):
        self._result = QDialog.Rejected
        self._visible = False
        self.finished.emit(self._result)

    def exec(self) -> int:
        # headless: dialogs are non-blocking; tests drive accept()/reject()
        self._visible = True
        return self._result

    def result(self) -> int:
        return self._result


class QMessageBox(QWidget):
    """Records messages instead of blocking; tests read `QMessageBox.shown`."""

    shown: list[tuple[str, str, str]] = []
    Ok = 0x400
    Cancel = 0x40000
    Yes = 0x4000
    No = 0x10000

    @classmethod
    def warning(cls, parent, title: str, text: str, *a, **k):
        cls.shown.append(("warning", title, text))
        return cls.Ok

    @classmethod
    def information(cls, parent, title: str, text: str, *a, **k):
        cls.shown.append(("information", title, text))
        return cls.Ok

    @classmethod
    def critical(cls, parent, title: str, text: str, *a, **k):
        cls.shown.append(("critical", title, text))
        return cls.Ok

    @classmethod
    def question(cls, parent, title: str, text: str, *a, **k):
        cls.shown.append(("question", title, text))
        return cls.Yes


class QFileDialog(QWidget):
    """Headless file dialogs return a preset path (tests set `next_path`)."""

    next_path: str = ""

    @classmethod
    def getExistingDirectory(cls, parent=None, caption: str = "", directory: str = "") -> str:
        return cls.next_path

    @classmethod
    def getOpenFileName(cls, parent=None, caption: str = "", directory: str = "", filter: str = ""):
        return cls.next_path, filter

    @classmethod
    def getSaveFileName(cls, parent=None, caption: str = "", directory: str = "", filter: str = ""):
        return cls.next_path, filter


# ---------------------------------------------------------------------------
# Round-4 additions: list widget, paint primitives, worker thread
# (the back half of the reference GUI surface — camera list sidebar,
# cameras tab, theme-styled rows, threaded live frame rendering)
# ---------------------------------------------------------------------------


class QColor:
    def __init__(self, spec="#000000"):
        self._spec = str(spec)

    def name(self) -> str:
        return self._spec

    def __eq__(self, other):
        return isinstance(other, QColor) and other._spec == self._spec

    def __repr__(self):
        return f"QColor({self._spec!r})"


class QBrush:
    def __init__(self, color: Optional[QColor] = None):
        self.color_obj = color or QColor()

    def color(self) -> QColor:
        return self.color_obj


class QListWidgetItem:
    def __init__(self, text: str = ""):
        self._text = text
        self._data: dict[int, object] = {}
        self._foreground: Optional[QBrush] = None

    def setText(self, t: str):
        self._text = str(t)

    def text(self) -> str:
        return self._text

    def setData(self, role: int, value):
        self._data[role] = value

    def data(self, role: int):
        return self._data.get(role)

    def setForeground(self, brush: QBrush):
        self._foreground = brush

    def foreground(self) -> Optional[QBrush]:
        return self._foreground


class QListWidget(QWidget):
    """Row-selection list; matches the PySide6 surface the camera list uses
    (currentRowChanged signal, UserRole payloads, blockSignals)."""

    currentRowChanged = Signal(int)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._items: list[QListWidgetItem] = []
        self._current_row = -1
        self._signals_blocked = False

    def clear(self):
        self._items.clear()
        self._current_row = -1

    def addItem(self, item: QListWidgetItem):
        self._items.append(item)

    def count(self) -> int:
        return len(self._items)

    def item(self, row: int) -> Optional[QListWidgetItem]:
        return self._items[row] if 0 <= row < len(self._items) else None

    def currentItem(self) -> Optional[QListWidgetItem]:
        return self.item(self._current_row)

    def currentRow(self) -> int:
        return self._current_row

    def blockSignals(self, yes: bool) -> bool:
        was = self._signals_blocked
        self._signals_blocked = bool(yes)
        return was

    def setCurrentRow(self, row: int):
        if row == self._current_row:
            return
        self._current_row = row
        if not self._signals_blocked:
            self.currentRowChanged.emit(row)

    def setMinimumWidth(self, w: int):
        self._minimum_size = (w, self._minimum_size[1])


class QThread(QObject):
    """Worker thread with the Qt lifecycle surface (start / run / wait /
    isRunning / finished). Runs a real Python thread; signals emitted from
    run() are queued to the GUI thread by _BoundSignal's AutoConnection
    logic, exactly like cross-thread Qt signals."""

    started = Signal()
    finished = Signal()

    def __init__(self, parent=None):
        super().__init__(parent)
        self._thread: Optional[threading.Thread] = None

    def run(self):  # subclass override point
        pass

    def _main(self):
        try:
            self.run()
        finally:
            self.finished.emit()

    def start(self):
        if self.isRunning():
            return
        self._thread = threading.Thread(target=self._main, daemon=True)
        self._thread.start()
        self.started.emit()

    def isRunning(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self, ms: int = 30000) -> bool:
        if self._thread is None:
            return True
        self._thread.join(ms / 1000.0)
        return not self._thread.is_alive()

    @staticmethod
    def msleep(ms: int):
        time.sleep(ms / 1000.0)
