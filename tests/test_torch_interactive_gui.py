"""The port's Qt widget layer (xmem2_tpu_torch/interactive/gui.py,
gui_utils.py) and `python -m xmem2_tpu_torch.interactive_demo`, executed
headlessly through the PyQt5 stub (tests/qt_stub.py) against the port's
SessionController / InferenceCore on the CPU: the same checks as
tests/test_gui_app.py runs on the JAX package's App.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tests import qt_stub

qt_stub.install()

from xmem2_tpu_torch.interactive.gui import App                    # noqa: E402
from xmem2_tpu_torch.interactive.gui_utils import (                # noqa: E402
    ImageLinkCollection, NamedSlider, Worker)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def synth_checkpoint(path):
    """The tests' XMem weights as a reference-format .pth."""
    from tests.test_torch_run_on_video import synth_params
    torch.save({k: torch.from_numpy(v) for k, v in synth_params().items()},
               path)


@pytest.fixture(scope='module')
def small_net(tmp_path_factory):
    from xmem2_tpu_torch.bridge.torch_params import load_model
    from xmem2_tpu_torch.inference.net import XMemNet
    path = tmp_path_factory.mktemp('xmem') / 'xmem.pth'
    synth_checkpoint(path)
    return XMemNet(load_model(str(path), 'cpu'), compute_dtype='float32',
                   device='cpu')


def _core(net, cfg):
    from xmem2_tpu_torch.inference.core import InferenceCore
    return InferenceCore(net, dict(cfg), device='cpu')


@pytest.fixture
def gui(tmp_path, small_net):
    from xmem2_tpu_torch.interactive.resource_manager import ResourceManager

    rng = np.random.default_rng(0)
    frames = tmp_path / 'frames'
    frames.mkdir()
    base = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    for i in range(6):
        Image.fromarray(np.roll(base, i * 2, axis=1)).save(
            frames / f'{i:05d}.jpg')

    cfg = {'hidden_dim': 64, 'top_k': 10, 'mem_every': 2,
           'deep_update_every': -1, 'enable_long_term': True,
           'enable_long_term_count_usage': True, 'max_mid_term_frames': 4,
           'min_mid_term_frames': 2, 'num_prototypes': 16,
           'max_long_term_elements': 1000, 'size': -1}
    rm = ResourceManager({'images': str(frames), 'video': None,
                          'workspace': str(tmp_path / 'ws'), 'size': -1,
                          'num_objects': 1, 'buffer_size': 10})
    app = App(_core(small_net, cfg), rm, None, None, cfg)
    return app, rm


def _paint_mask(app):
    mask = np.zeros((48, 64), np.uint8)
    mask[16:32, 24:40] = 1
    app.ctl.res_man.save_mask(app.ctl.cursur, mask)
    return mask


class TestAppWiring:
    def test_construction_builds_widgets_and_canvas(self, gui):
        app, rm = gui
        assert app.tl_slider.value() == 0
        assert app.canvas.pixmap() is not None
        assert app.canvas.pixmap().width() == 64
        assert app.viz_combo.currentText() == 'davis'
        assert app.num_frames == 6

    def test_slider_moves_cursor_and_redraws(self, gui):
        app, rm = gui
        app.tl_slider.setValue(2)
        assert app.cursur == 2
        app.tl_slider.setValue(0)
        assert app.cursur == 0

    def test_keyboard_shortcuts_step_frames(self, gui):
        app, rm = gui
        from tests.qt_stub import QShortcut
        right = QShortcut.instances[-1]
        left = QShortcut.instances[-2]
        right.activated.emit()
        assert app.cursur == 1
        left.activated.emit()
        assert app.cursur == 0

    def test_viz_combo_changes_mode(self, gui):
        app, rm = gui
        app.viz_combo.setCurrentText('fade')
        assert app.ctl.viz_mode == 'fade'

    def test_object_spin(self, gui):
        app, rm = gui
        app.object_spin.setValue(1)
        assert app.ctl.current_object == 1

    def test_propagate_button_walks_timeline(self, gui):
        app, rm = gui
        _paint_mask(app)
        app.btn_prop_fwd.click()
        assert app.cursur == 5
        for ti in range(6):
            assert rm.get_mask(ti) is not None

    def test_full_propagation_and_clear_memory(self, gui):
        app, rm = gui
        _paint_mask(app)
        app.btn_save_ref.click()
        assert app.references_tab.frames == [0]
        app.btn_prop_full.click()
        assert rm.get_mask(2) is not None
        app.btn_clear_mem.click()
        stats = app.ctl.memory_stats()
        assert stats['temp'] == 0 and stats['perm'] > 0   # permanent kept

    def test_save_and_remove_reference_updates_tab(self, gui):
        app, rm = gui
        _paint_mask(app)
        app.btn_save_ref.click()
        assert app.references_tab.frames == [0]
        app.btn_remove_ref.click()
        assert app.references_tab.frames == []

    def test_candidates_worker_runs_through_threadpool(self, gui):
        app, rm = gui
        _paint_mask(app)
        app.btn_save_ref.click()
        app.btn_prop_fwd.click()
        app.btn_candidates.click()          # stub pool runs inline
        assert len(app.candidates_tab.frames) > 0
        assert any('candidates' in ln for ln in app.console.lines)

    def test_memory_sliders_reach_engine_config(self, gui):
        app, rm = gui
        app.mem_sliders['top_k'].slider.setValue(7)
        assert app.ctl.processor.memory.top_k == 7
        app.mem_sliders['mem_every'].slider.setValue(9)
        assert app.ctl.processor.mem_every == 9

    def test_gauge_timer_updates_labels(self, gui):
        app, rm = gui
        _paint_mask(app)
        app.btn_save_ref.click()
        from tests.qt_stub import QTimer
        for t in QTimer.instances:
            if t.active:
                t.fire()
        assert 'perm' in app.mem_gauge.text()
        assert app.mem_gauge.text() != 'memory: -'

    def test_mouse_brush_path_commits_mask(self, gui):
        app, rm = gui
        ev = qt_stub._Event(30, 20)
        app.canvas.mousePressEvent(ev)
        app.canvas.mouseMoveEvent(qt_stub._Event(34, 24))
        app.canvas.mouseReleaseEvent(qt_stub._Event(34, 24))
        assert rm.get_mask(0) is not None and rm.get_mask(0).max() == 1

    def test_import_mask_via_file_dialog(self, gui, tmp_path):
        app, rm = gui
        mpath = tmp_path / 'ext_mask.png'
        m = np.zeros((48, 64), np.uint8)
        m[4:10, 4:10] = 1
        Image.fromarray(m, mode='P').save(mpath)
        qt_stub.QFileDialog.next_file = str(mpath)
        try:
            app.btn_import_mask.click()
        finally:
            qt_stub.QFileDialog.next_file = ''
        assert rm.get_mask(0).max() == 1

    def test_import_layer_switches_viz(self, gui, tmp_path):
        app, rm = gui
        lpath = tmp_path / 'layer.png'
        rgba = np.zeros((48, 64, 4), np.uint8)
        rgba[..., 3] = 128
        Image.fromarray(rgba, mode='RGBA').save(lpath)
        qt_stub.QFileDialog.next_file = str(lpath)
        try:
            app.btn_import_layer.click()
        finally:
            qt_stub.QFileDialog.next_file = ''
        assert app.viz_combo.currentText() == 'layered'
        assert app.ctl.viz_mode == 'layered'

    def test_empty_file_dialog_is_noop(self, gui):
        app, rm = gui
        qt_stub.QFileDialog.next_file = ''
        app.btn_import_mask.click()          # must not raise

    def test_commit_button_finalizes_interaction(self, gui):
        """Commit button parity (reference gui.py:81-83, 804-806)."""
        app, rm = gui
        app.canvas.mousePressEvent(qt_stub._Event(30, 20))
        app.canvas.mouseMoveEvent(qt_stub._Event(34, 24))
        assert app.ctl.interaction is not None
        app.btn_commit.click()
        assert app.ctl.interaction is None
        assert rm.get_mask(0) is not None and rm.get_mask(0).max() == 1
        app.btn_commit.click()               # idle commit must not raise

    def test_reset_mask_button_zeroes_current_frame(self, gui):
        """Reset-mask button parity (reference gui.py:107, 910-917)."""
        app, rm = gui
        _paint_mask(app)
        assert rm.get_mask(0).max() == 1
        app.btn_reset_mask.click()
        assert rm.get_mask(0).max() == 0

    def test_import_all_masks_button(self, gui, tmp_path):
        """Import-ALL-masks button parity (reference gui.py:236-238,
        1143-1191): bulk path imports every mask and rewinds to frame 0."""
        app, rm = gui
        d = tmp_path / 'masks'
        d.mkdir()
        for fi in range(6):
            m = np.zeros((48, 64), np.uint8)
            m[4:10, 4:10] = 1
            Image.fromarray(m, mode='P').save(d / f'{fi:05d}.png')
        qt_stub.QFileDialog.next_dir = str(d)
        try:
            app.btn_import_all_masks.click()
        finally:
            qt_stub.QFileDialog.next_dir = ''
        for fi in range(6):
            assert rm.get_mask(fi) is not None and rm.get_mask(fi).max() == 1
        # 6 <= bulk threshold (10): small-batch path saves references and
        # parks the cursor at the last import (reference gui.py:1189-1191)
        assert app.cursur == 5
        assert sorted(app.references_tab.frames) == list(range(6))
        assert any('Imported 6 masks' in ln for ln in app.console.lines)

    def test_import_all_masks_empty_dialog_is_noop(self, gui):
        app, rm = gui
        qt_stub.QFileDialog.next_dir = ''
        app.btn_import_all_masks.click()     # must not raise

    def test_play_video_timer_advances_and_wraps(self, gui):
        """Play/pause: reference gui.py:78-80, 387-397, 896-908 — the timer
        steps the cursor each tick and wraps at the last frame."""
        app, rm = gui
        assert not app.play_timer.isActive()
        app.btn_play.click()
        assert app.play_timer.isActive()
        assert app.btn_play.text() == 'Stop Video'
        for _ in range(app.num_frames - 1):
            app.play_timer.fire()
        assert app.cursur == app.num_frames - 1
        app.play_timer.fire()                   # wraps to frame 0
        assert app.cursur == 0
        app.btn_play.click()                    # pause
        assert not app.play_timer.isActive()
        assert app.btn_play.text() == 'Play Video'

    def test_save_visualization_toggle(self, gui):
        """Save-viz toggle: reference gui.py:151-154, 542-543 — unchecked
        means show_current_frame stops writing overlay files."""
        app, rm = gui
        assert app.save_visualization
        app.save_viz_checkbox.setChecked(False)
        assert not app.save_visualization
        seen = {}
        orig = rm.save_visualization
        rm.save_visualization = (
            lambda ti, viz: seen.setdefault('hit', True) or orig(ti, viz))
        try:
            app.show_current_frame()
            assert 'hit' not in seen
            app.save_viz_checkbox.setChecked(True)
            app.show_current_frame()
            assert seen.get('hit')
        finally:
            rm.save_visualization = orig

    def test_brush_size_slider_reaches_controller(self, gui):
        """Brush-size slider: reference gui.py:133-137, 676-689."""
        app, rm = gui
        app.brush_slider.slider.setValue(17)
        assert app.ctl.brush_size == 17

    def test_minimap_zoom_buttons_and_mouse_tracking(self, gui):
        """Minimap + zoom: reference gui.py:193-196, 318-322, 509-536,
        919-926 — mouse movement drives the crop center; the zoom buttons
        shrink/grow the crop window within [50, 300]."""
        app, rm = gui
        z0 = app.zoom_pixels
        app.btn_zoom_plus.click()
        assert app.zoom_pixels == max(50, z0 - 25)
        app.btn_zoom_minus.click()
        app.btn_zoom_minus.click()
        assert app.zoom_pixels == min(300, z0 + 25)
        app.canvas.mouseMoveEvent(qt_stub._Event(30, 20))
        assert (app.last_ex, app.last_ey) == (30, 20)
        assert app.minimap.pixmap() is not None

    def test_references_replayed_on_restart(self, gui, small_net):
        app, rm = gui
        _paint_mask(app)
        app.btn_save_ref.click()
        proc2 = _core(small_net, app.ctl.config)
        app2 = App(proc2, rm, None, None, app.ctl.config)
        assert app2.references_tab.frames == [0]
        assert 0 in proc2.permanent_memory_frames


class TestGuiUtilsWidgets:
    def test_named_slider_label_and_multiplier(self):
        s = NamedSlider('x', 0, 100, 5, 40, multiplier=2)
        assert s.value() == 80
        assert s.value_label.text() == '80'
        seen = []
        s.valueChanged.connect(seen.append)
        s.slider.setValue(10)
        assert seen == [10] and s.value() == 20

    def test_worker_result_and_error_signals(self):
        results, errors, finished = [], [], []
        w = Worker(lambda a, b: a + b, 2, 3)
        w.signals.result.connect(results.append)
        w.signals.finished.connect(lambda: finished.append(True))
        w.run()
        assert results == [5] and finished == [True]

        w2 = Worker(lambda: 1 / 0)
        w2.signals.error.connect(errors.append)
        w2.signals.finished.connect(lambda: finished.append(True))
        w2.run()
        assert errors and errors[0][0] is ZeroDivisionError
        assert len(finished) == 2

    def test_image_link_collection_add_remove_clear(self):
        clicks = []
        coll = ImageLinkCollection(clicks.append,
                                   lambda fi: qt_stub.QPixmap(8, 8))
        coll.add_image(3)
        coll.add_image(5)
        coll.add_image(3)                     # duplicate ignored
        assert coll.frames == [3, 5]
        assert coll.vbox.count() == 2
        coll.vbox.items[0].widget().mousePressEvent(None)
        assert clicks == [3]
        coll.remove_image(3)
        assert coll.frames == [5] and coll.vbox.count() == 1
        coll.clear()
        assert coll.frames == [] and coll.vbox.count() == 0


class TestInteractiveDemoBootstrap:
    def test_main_constructs_app_and_exits(self, tmp_path):
        """Drive xmem2_tpu_torch.interactive_demo.main() end to end on the
        CPU: synthetic XMem, S2M and f-BRS weights on disk, an images
        folder, the stubbed Qt event loop."""
        from tests.test_torch_fbrs import synth_pth
        from xmem2_tpu_torch import interactive_demo
        from xmem2_tpu_torch.interactive.fbrs.model import FBRSModel
        from xmem2_tpu_torch.interactive.s2m.network import S2MNet

        frames = tmp_path / 'frames'
        frames.mkdir()
        rng = np.random.default_rng(0)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (48, 64, 3), np.uint8)).save(
                frames / f'{i:05d}.jpg')
        synth_checkpoint(tmp_path / 'xmem.pth')
        synth_pth(S2MNet(stem=8, base=8, ch=16, low_ch=8), tmp_path / 's2m.pth')
        synth_pth(FBRSModel(stem=8, base=8, ch=16), tmp_path / 'fbrs.pth')
        with pytest.raises(SystemExit) as exc:
            interactive_demo.main([
                '--model', str(tmp_path / 'xmem.pth'),
                '--s2m_model', str(tmp_path / 's2m.pth'),
                '--fbrs_model', str(tmp_path / 'fbrs.pth'),
                '--images', str(frames), '--workspace', str(tmp_path / 'ws'),
                '--size', '-1', '--num_objects', '2', '--no_amp',
                '--device', 'cpu'])
        assert exc.value.code == 0            # stub QApplication.exec_() -> 0
        assert (tmp_path / 'ws' / 'info.json').exists()

    def test_without_pyqt5_prints_and_exits_1(self, tmp_path):
        """Without PyQt5 the demo prints the JAX package's message and exits
        1 (the card is checked first: --device cpu here)."""
        env = dict(os.environ, PYTHONPATH=str(REPO))
        out = subprocess.run(
            [sys.executable, '-c',
             "import sys; sys.modules['PyQt5'] = None\n"
             "sys.modules['PyQt5.QtWidgets'] = None\n"
             "from xmem2_tpu_torch.interactive_demo import main\n"
             "main(['--device', 'cpu'])"],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 1, out.stderr
        assert 'PyQt5 is required for the GUI' in out.stdout
