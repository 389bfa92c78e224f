"""Interactive annotation GUI (PyQt5).

Counterpart of xmem2_tpu/interactive/gui.py, the same widgets over the
port's SessionController. Behavioral parity target: reference
inference/interact/gui.py (App :50):
timeline slider, brush/scribble/click interactions, forward/backward/FULL
propagation, permanent-memory reference management, annotation-candidate
computation, live memory-parameter controls, overlay visualization modes,
mask/layer import, memory gauges.

All non-widget logic lives in SessionController (interactive/session.py),
which is unit-tested headlessly; this module is widget plumbing only and
imports iff PyQt5 is installed (the engine and Python API never require Qt).
"""

import numpy as np

from PyQt5.QtCore import Qt, QTimer, QThreadPool
from PyQt5.QtGui import QImage, QPixmap, QKeySequence
from PyQt5.QtWidgets import (
    QApplication, QButtonGroup, QCheckBox, QComboBox, QFileDialog,
    QHBoxLayout, QLabel, QMainWindow, QPlainTextEdit, QPushButton,
    QRadioButton, QShortcut, QSlider, QSpinBox, QTabWidget, QVBoxLayout,
    QWidget)

from xmem2_tpu_torch.interactive.gui_utils import (
    ImageLinkCollection, NamedSlider, Worker)
from xmem2_tpu_torch.interactive.session import SessionController


def _np_to_pixmap(arr: np.ndarray) -> QPixmap:
    h, w, _ = arr.shape
    img = QImage(np.ascontiguousarray(arr).data, w, h, 3 * w,
                 QImage.Format_RGB888)
    return QPixmap.fromImage(img.copy())


class App(QMainWindow):
    def __init__(self, processor, resource_manager, s2m_ctrl, fbrs_ctrl,
                 config):
        super().__init__()
        self.ctl = SessionController(processor, resource_manager,
                                     s2m_ctrl, fbrs_ctrl, config,
                                     log=self.text)
        self.res_man = resource_manager

        self.threadpool = QThreadPool()
        self._build_ui()
        for fi in self.ctl.replay_references():
            self.references_tab.add_image(fi)
        self.show_current_frame()

    # convenience passthroughs -------------------------------------------
    @property
    def cursur(self):
        return self.ctl.cursur

    @property
    def num_frames(self):
        return self.ctl.num_frames

    # ------------------------------------------------------------------ UI
    def _build_ui(self):
        self.setWindowTitle('xmem2_tpu_torch interactive segmentation')
        central = QWidget()
        self.setCentralWidget(central)

        self.canvas = QLabel()
        self.canvas.setMouseTracking(True)
        self.canvas.mousePressEvent = self.on_mouse_press
        self.canvas.mouseMoveEvent = self.on_mouse_move
        self.canvas.mouseReleaseEvent = self.on_mouse_release

        self.tl_slider = QSlider(Qt.Horizontal)
        self.tl_slider.setMaximum(self.ctl.num_frames - 1)
        self.tl_slider.valueChanged.connect(self.on_slider)

        # play/pause video timer (reference gui.py:78-80, 387-389, 896-908)
        self.play_fps = int(self.ctl.config.get('play_fps', 30))
        self.play_timer = QTimer(self)
        self.play_timer.setSingleShot(False)
        self.play_timer.timeout.connect(self.on_play_video_timer)
        self.btn_play = QPushButton('Play Video')
        self.btn_play.setToolTip('Play/Pause the video')
        self.btn_play.clicked.connect(self.on_play_video)

        # save-visualization toggle (reference gui.py:151-154, 542-543)
        self.save_viz_checkbox = QCheckBox('Save overlay')
        self.save_viz_checkbox.setChecked(True)
        self.save_viz_checkbox.toggled.connect(
            self.on_save_visualization_toggle)
        self.save_visualization = True

        # brush size slider (reference gui.py:133-137, 676-689)
        self.brush_slider = NamedSlider('Brush size', 1, 100, 1,
                                        self.ctl.brush_size)
        self.brush_slider.valueChanged.connect(self.on_brush_size)

        # interaction mode
        self.mode_group = QButtonGroup()
        mode_row = QHBoxLayout()
        self.radio_free = QRadioButton('Brush')
        self.radio_scribble = QRadioButton('Scribble (S2M)')
        self.radio_click = QRadioButton('Click (fBRS)')
        self.radio_free.setChecked(True)
        for b in (self.radio_free, self.radio_scribble, self.radio_click):
            self.mode_group.addButton(b)
            mode_row.addWidget(b)

        # object selector
        self.object_spin = QSpinBox()
        self.object_spin.setRange(1, self.ctl.num_objects)
        self.object_spin.valueChanged.connect(self.on_object_changed)
        mode_row.addWidget(QLabel('Object:'))
        mode_row.addWidget(self.object_spin)

        # viz mode
        self.viz_combo = QComboBox()
        self.viz_combo.addItems(['davis', 'fade', 'light', 'popup', 'layered'])
        self.viz_combo.currentTextChanged.connect(self.on_viz_mode)
        mode_row.addWidget(QLabel('Overlay:'))
        mode_row.addWidget(self.viz_combo)

        # propagation buttons
        prop_row = QHBoxLayout()
        self.btn_prop_fwd = QPushButton('Propagate →')
        self.btn_prop_bwd = QPushButton('← Propagate')
        self.btn_prop_full = QPushButton('FULL Propagate')
        self.btn_stop = QPushButton('Stop')
        self.btn_clear_mem = QPushButton('Clear memory')
        self.btn_prop_fwd.clicked.connect(lambda: self.on_propagation('forward'))
        self.btn_prop_bwd.clicked.connect(lambda: self.on_propagation('backward'))
        self.btn_prop_full.clicked.connect(self.on_full_propagation)
        self.btn_stop.clicked.connect(self.ctl.stop)
        self.btn_clear_mem.clicked.connect(self.on_clear_memory)
        for b in (self.btn_prop_bwd, self.btn_prop_full, self.btn_prop_fwd,
                  self.btn_stop, self.btn_clear_mem, self.btn_play):
            prop_row.addWidget(b)
        prop_row.addWidget(self.save_viz_checkbox)

        # reference / candidate actions
        ref_row = QHBoxLayout()
        self.btn_save_ref = QPushButton('Save reference')
        self.btn_remove_ref = QPushButton('Remove reference')
        self.btn_candidates = QPushButton('Compute annotation candidates')
        self.btn_import_mask = QPushButton('Import mask')
        self.btn_import_all_masks = QPushButton('Import ALL masks')
        self.btn_import_layer = QPushButton('Import layer')
        self.btn_commit = QPushButton('Commit')
        self.btn_commit.setToolTip('Finish current interaction with the mask')
        self.btn_reset_mask = QPushButton('Reset mask')
        self.btn_reset_mask.setToolTip(
            "Zero the current frame's mask (negative-mask workaround)")
        self.btn_save_ref.clicked.connect(self.on_save_reference)
        self.btn_remove_ref.clicked.connect(self.on_remove_reference)
        self.btn_candidates.clicked.connect(self.on_compute_candidates)
        self.btn_import_mask.clicked.connect(self.on_import_mask)
        self.btn_import_all_masks.clicked.connect(self.on_import_all_masks)
        self.btn_import_layer.clicked.connect(self.on_import_layer)
        self.btn_commit.clicked.connect(self.on_commit)
        self.btn_reset_mask.clicked.connect(self.on_reset_mask)
        for b in (self.btn_commit, self.btn_reset_mask, self.btn_save_ref,
                  self.btn_remove_ref, self.btn_candidates,
                  self.btn_import_mask, self.btn_import_all_masks,
                  self.btn_import_layer):
            ref_row.addWidget(b)

        # live memory parameters (reference gui.py:1090-1128)
        cfg = self.ctl.config
        self.mem_sliders = {
            'mem_every': NamedSlider('mem every', 1, 100, 1,
                                     cfg['mem_every']),
            'top_k': NamedSlider('top k', 5, 100, 1, cfg['top_k']),
            'max_mid_term_frames': NamedSlider(
                'max mid-term', 4, 100, 1, cfg['max_mid_term_frames']),
            'min_mid_term_frames': NamedSlider(
                'min mid-term', 3, 99, 1, cfg['min_mid_term_frames']),
            'num_prototypes': NamedSlider(
                'prototypes', 32, 1280, 32, cfg['num_prototypes']),
            'max_long_term_elements': NamedSlider(
                'max long-term', 1000, 100000, 1000,
                cfg['max_long_term_elements']),
        }
        mem_col = QVBoxLayout()
        for s in self.mem_sliders.values():
            s.valueChanged.connect(self.update_config)
            mem_col.addWidget(s)

        # minimap + zoom (reference gui.py:193-196, 318-322, 524-536)
        self.minimap = QLabel()
        self.minimap.setMinimumSize(100, 100)
        self.zoom_pixels = 150
        self.last_ex = self.last_ey = 0.0
        self.btn_zoom_plus = QPushButton('Zoom +')
        self.btn_zoom_minus = QPushButton('Zoom -')
        self.btn_zoom_plus.clicked.connect(self.on_zoom_plus)
        self.btn_zoom_minus.clicked.connect(self.on_zoom_minus)

        # gauges (reference gui.py:1073-1088)
        self.mem_gauge = QLabel('memory: -')
        self.gpu_gauge = QLabel('device: -')
        gauge_timer = QTimer(self)
        gauge_timer.timeout.connect(self.update_memory_size)
        gauge_timer.start(2000)

        self.console = QPlainTextEdit()
        self.console.setReadOnly(True)
        self.console.setMaximumHeight(100)

        self.references_tab = ImageLinkCollection(
            self.jump_to_frame, self._thumbnail, name='References')
        self.candidates_tab = ImageLinkCollection(
            self.jump_to_frame, self._thumbnail, name='Candidates')
        tabs = QTabWidget()
        tabs.addTab(self.references_tab, 'References')
        tabs.addTab(self.candidates_tab, 'Candidates')

        left = QVBoxLayout()
        left.addWidget(self.canvas)
        left.addWidget(self.tl_slider)
        left.addLayout(mode_row)
        left.addLayout(prop_row)
        left.addLayout(ref_row)
        left.addWidget(self.console)

        zoom_row = QHBoxLayout()
        zoom_row.addWidget(self.btn_zoom_plus)
        zoom_row.addWidget(self.btn_zoom_minus)

        right = QVBoxLayout()
        right.addWidget(self.brush_slider)
        right.addLayout(mem_col)
        right.addWidget(QLabel('Minimap'))
        right.addLayout(zoom_row)
        right.addWidget(self.minimap)
        right.addWidget(self.mem_gauge)
        right.addWidget(self.gpu_gauge)
        right.addWidget(tabs)

        root = QHBoxLayout()
        root.addLayout(left, 4)
        root.addLayout(right, 1)
        central.setLayout(root)

        QShortcut(QKeySequence(Qt.Key_Left), self).activated.connect(
            lambda: self.tl_slider.setValue(max(0, self.ctl.cursur - 1)))
        QShortcut(QKeySequence(Qt.Key_Right), self).activated.connect(
            lambda: self.tl_slider.setValue(
                min(self.ctl.num_frames - 1, self.ctl.cursur + 1)))

    def text(self, msg):
        self.console.appendPlainText(str(msg))

    def _mode(self) -> str:
        if self.radio_click.isChecked():
            return 'click'
        if self.radio_scribble.isChecked():
            return 'scribble'
        return 'free'

    # ------------------------------------------------------------- frames
    def _thumbnail(self, frame_id):
        img = self.res_man.get_image(frame_id)
        small = img[::4, ::4]
        return _np_to_pixmap(np.ascontiguousarray(small))

    def show_current_frame(self):
        self._last_viz = self.ctl.visualization(save=self.save_visualization)
        self.canvas.setPixmap(_np_to_pixmap(self._last_viz))
        self.update_minimap()

    def jump_to_frame(self, fi):
        self.tl_slider.setValue(fi)

    # ------------------------------------------------------------- events
    def on_slider(self, value):
        self.ctl.set_cursor(value)
        self.show_current_frame()

    # play/pause (reference gui.py:896-908: wraps at the last frame,
    # 1000/30 ms default period)
    def on_play_video_timer(self):
        nxt = self.ctl.cursur + 1
        if nxt > self.ctl.num_frames - 1:
            nxt = 0
        self.tl_slider.setValue(nxt)

    def on_play_video(self):
        if self.play_timer.isActive():
            self.play_timer.stop()
            self.btn_play.setText('Play Video')
        else:
            self.play_timer.start(int(1000 / max(self.play_fps, 1)))
            self.btn_play.setText('Stop Video')

    def on_save_visualization_toggle(self, checked):
        self.save_visualization = bool(checked)

    def on_brush_size(self):
        self.ctl.set_brush_size(int(self.brush_slider.value()))

    # minimap + zoom (reference gui.py:524-536, 919-926): a zoom_pixels-wide
    # crop of the current visualization around the last cursor position
    def update_minimap(self):
        viz = getattr(self, '_last_viz', None)
        if viz is None:
            return
        r = self.zoom_pixels // 2
        h, w = viz.shape[:2]
        ex = int(round(max(r, min(w - r, self.last_ex))))
        ey = int(round(max(r, min(h - r, self.last_ey))))
        patch = np.ascontiguousarray(viz[ey - r:ey + r, ex - r:ex + r])
        if patch.size == 0:
            return
        pix = _np_to_pixmap(patch)
        self.minimap.setPixmap(pix.scaled(
            self.minimap.size(), Qt.KeepAspectRatio, Qt.FastTransformation))

    def on_zoom_plus(self):
        self.zoom_pixels = max(50, self.zoom_pixels - 25)
        self.update_minimap()

    def on_zoom_minus(self):
        self.zoom_pixels = min(300, self.zoom_pixels + 25)
        self.update_minimap()

    def on_viz_mode(self, mode):
        self.ctl.viz_mode = mode
        self.show_current_frame()

    def on_object_changed(self, value):
        self.ctl.current_object = value

    def _canvas_coords(self, event):
        pix = self.canvas.pixmap()
        if pix is None:
            return None
        x = event.pos().x() * self.ctl.width / max(pix.width(), 1)
        y = event.pos().y() * self.ctl.height / max(pix.height(), 1)
        return float(np.clip(x, 0, self.ctl.width - 1)), \
            float(np.clip(y, 0, self.ctl.height - 1))

    def on_mouse_press(self, event):
        coords = self._canvas_coords(event)
        if coords is None:
            return
        self.last_ex, self.last_ey = coords
        is_neg = event.button() == Qt.RightButton
        committed = self.ctl.push_point(coords[0], coords[1], is_neg,
                                        self._mode())
        if committed is not None:
            self.show_current_frame()

    def on_mouse_move(self, event):
        coords = self._canvas_coords(event)
        if coords is None:
            return
        # all-time tracking drives the minimap crop (reference gui.py:509-536)
        self.last_ex, self.last_ey = coords
        self.update_minimap()
        if self.ctl.interaction is None or self._mode() == 'click':
            return
        if not (event.buttons() & (Qt.LeftButton | Qt.RightButton)):
            return
        is_neg = bool(event.buttons() & Qt.RightButton)
        self.ctl.push_point(coords[0], coords[1], is_neg, self._mode())

    def on_mouse_release(self, event):
        if self.ctl.interaction is None or self._mode() == 'click':
            return
        if self.ctl.end_path() is not None:
            self.show_current_frame()

    # -------------------------------------------------------- propagation
    def _on_prop_frame(self, ti):
        self.tl_slider.blockSignals(True)
        self.tl_slider.setValue(ti)
        self.tl_slider.blockSignals(False)
        self.show_current_frame()
        QApplication.processEvents()

    def on_propagation(self, direction):
        self.ctl.propagate(direction, on_frame=self._on_prop_frame)

    def on_full_propagation(self):
        self.ctl.full_propagate(on_frame=self._on_prop_frame)

    def on_clear_memory(self):
        self.ctl.clear_memory()
        self.update_memory_size()

    # --------------------------------------------------------- references
    def on_save_reference(self):
        if self.ctl.save_reference():
            self.references_tab.add_image(self.ctl.cursur)

    def on_remove_reference(self):
        if self.ctl.remove_reference():
            self.references_tab.remove_image(self.ctl.cursur)

    # --------------------------------------------------------- candidates
    def on_compute_candidates(self):
        """Run the diversity selector off the UI thread
        (reference gui.py:818-850)."""
        worker = Worker(self.ctl.compute_candidates)
        worker.signals.result.connect(self._show_candidates)
        worker.signals.error.connect(lambda e: self.text(e[2]))
        self.threadpool.start(worker)
        self.text('Computing annotation candidates...')

    def _show_candidates(self, candidates):
        if candidates is None:
            return
        self.candidates_tab.clear()
        for fi in candidates:
            self.candidates_tab.add_image(int(fi))
        self.text(f'Next annotation candidates: {candidates}')

    # --------------------------------------------------------- interaction
    def on_commit(self):
        """Explicit Commit (reference gui.py:804-806)."""
        if self.ctl.commit() is not None:
            self.show_current_frame()

    def on_reset_mask(self):
        """Zero the current frame's mask (reference gui.py:910-917)."""
        self.ctl.reset_mask()
        self.show_current_frame()

    # ------------------------------------------------------------- import
    def on_import_mask(self):
        file_name, _ = QFileDialog.getOpenFileName(self, 'Select mask file')
        if not file_name:
            return
        if self.ctl.import_mask(file_name) \
                and self.ctl.cursur in self.res_man.references:
            self.references_tab.add_image(self.ctl.cursur)
        self.show_current_frame()

    def on_import_all_masks(self):
        """Bulk mask import (reference gui.py:1143-1191)."""
        dir_path = QFileDialog.getExistingDirectory(
            self, 'Select mask directory')
        if not dir_path:
            return
        result = self.ctl.import_all_masks(
            dir_path, on_progress=lambda i: QApplication.processEvents())
        for fi in sorted(self.res_man.references):
            self.references_tab.add_image(fi)
        self.text(f"Imported {result['imported']} masks"
                  + (f"; errors: {result['errors']}" if result['errors']
                     else ''))
        self.tl_slider.setValue(self.ctl.cursur)
        self.show_current_frame()

    def on_import_layer(self):
        file_name, _ = QFileDialog.getOpenFileName(self, 'Select RGBA layer')
        if not file_name:
            return
        if self.ctl.import_layer(file_name):
            self.viz_combo.setCurrentText('layered')

    # -------------------------------------------------------------- misc
    def update_config(self):
        self.ctl.update_config({key: int(slider.value())
                                for key, slider in self.mem_sliders.items()})

    def update_memory_size(self):
        stats = self.ctl.memory_stats()
        self.mem_gauge.setText(
            f"memory: temp {stats['temp']} | perm {stats['perm']} | "
            f"long {stats['long']}")
        if 'device_bytes_in_use' in stats:
            self.gpu_gauge.setText(
                f"device: {stats['device_bytes_in_use'] / 2**20:.0f} MB")
        else:
            self.gpu_gauge.setText('device: n/a')
