"""Qt helper widgets for the interactive GUI (import requires PyQt5).

Copy of xmem2_tpu/interactive/gui_utils.py (reference
inference/interact/gui_utils.py: Worker/WorkerSignals thread-pool jobs
:13-77, NamedSlider :263, ImageLinkCollection :355). Only imported from
gui.py, which is itself gated on PyQt5 availability.
"""

import sys
import traceback

from PyQt5.QtCore import QObject, QRunnable, Qt, pyqtSignal, pyqtSlot
from PyQt5.QtWidgets import (QHBoxLayout, QLabel, QProgressBar, QScrollArea,
                             QSlider, QVBoxLayout, QWidget)


class WorkerSignals(QObject):
    finished = pyqtSignal()
    error = pyqtSignal(tuple)
    result = pyqtSignal(object)
    progress = pyqtSignal(int)


class Worker(QRunnable):
    """Thread-pool job wrapper (off the UI thread), reference gui_utils.py:38."""

    def __init__(self, fn, *args, **kwargs):
        super().__init__()
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.signals = WorkerSignals()
        if kwargs.pop('progress_callback_in_kwargs', False):
            self.kwargs['progress_callback'] = self.signals.progress

    @pyqtSlot()
    def run(self):
        try:
            result = self.fn(*self.args, **self.kwargs)
        except Exception:
            traceback.print_exc()
            exctype, value = sys.exc_info()[:2]
            self.signals.error.emit((exctype, value, traceback.format_exc()))
        else:
            self.signals.result.emit(result)
        finally:
            self.signals.finished.emit()


class NamedSlider(QWidget):
    """Labelled slider with value readout (reference gui_utils.py:263)."""

    def __init__(self, name, min_val, max_val, step, default, multiplier=1,
                 min_text=None, max_text=None):
        super().__init__()
        self.multiplier = multiplier
        self.name = name
        layout = QHBoxLayout()
        layout.addWidget(QLabel(name))
        self.slider = QSlider(Qt.Horizontal)
        self.slider.setMinimum(min_val)
        self.slider.setMaximum(max_val)
        self.slider.setSingleStep(step)
        self.slider.setValue(default)
        layout.addWidget(self.slider)
        self.value_label = QLabel()
        layout.addWidget(self.value_label)
        self.setLayout(layout)
        self.slider.valueChanged.connect(self._update_label)
        self._update_label()

    def value(self):
        return self.slider.value() * self.multiplier

    def _update_label(self):
        self.value_label.setText(f'{self.value():g}')

    @property
    def valueChanged(self):
        return self.slider.valueChanged


class ImageLinkCollection(QWidget):
    """Scrollable thumbnail list with click callbacks (references /
    candidates tabs; reference gui_utils.py:355)."""

    def __init__(self, on_click, load_image_fn, delete_fn=None, name=''):
        super().__init__()
        self.on_click = on_click
        self.load_image_fn = load_image_fn
        self.delete_fn = delete_fn
        self.name = name
        self.frames = []

        self.inner = QWidget()
        self.vbox = QVBoxLayout()
        self.inner.setLayout(self.vbox)
        scroll = QScrollArea()
        scroll.setWidget(self.inner)
        scroll.setWidgetResizable(True)
        outer = QVBoxLayout()
        outer.addWidget(QLabel(name))
        outer.addWidget(scroll)
        self.setLayout(outer)

    def add_image(self, frame_id):
        if frame_id in self.frames:
            return
        self.frames.append(frame_id)
        label = QLabel()
        label.setPixmap(self.load_image_fn(frame_id))
        label.mousePressEvent = lambda e, fi=frame_id: self.on_click(fi)
        label.setProperty('frame_id', frame_id)
        self.vbox.addWidget(label)

    def remove_image(self, frame_id):
        if frame_id not in self.frames:
            return
        idx = self.frames.index(frame_id)
        self.frames.pop(idx)
        item = self.vbox.takeAt(idx)
        if item.widget() is not None:
            item.widget().deleteLater()

    def clear(self):
        for fi in list(self.frames):
            self.remove_image(fi)
