"""The host side of the port's interactive layer against the JAX package's
on the CPU: palette conversion, overlays, frame conversion, the bilinear
resize's two conventions, the cv2 substitutes (stroke rasterizer, INTER_AREA
resize) against cv2, click distance maps (native library built into build/,
numpy BFS, tensor formula), aggregation, the interaction types, the
workspace (ResourceManager) and import_existing against the root script.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------ utils and overlays

def test_palette_converter_matches_jax():
    from xmem2_tpu.utils.image_loader import PaletteConverter as J
    from xmem2_tpu_torch.utils.image_loader import PaletteConverter as T
    from xmem2_tpu_torch.utils.palette import davis_palette
    rng = np.random.default_rng(0)
    colours = np.array([[0, 0, 0], [200, 10, 10], [10, 200, 10],
                        [10, 10, 200]], np.uint8)
    j, t = J(davis_palette), T(davis_palette)
    for _ in range(3):
        rgb = colours[rng.integers(0, 4, (24, 32))]
        img = Image.fromarray(rgb)
        a = np.asarray(j.image_to_index_mask(img))
        b = np.asarray(t.image_to_index_mask(img))
        np.testing.assert_array_equal(a, b)
    assert j.num_objects == t.num_objects > 0


@pytest.mark.parametrize('mode', ['davis', 'fade', 'light', 'popup',
                                  'layered'])
def test_overlays_byte_equal(mode):
    from xmem2_tpu.interactive.interactive_utils import get_visualization as J
    from xmem2_tpu_torch.interactive.interactive_utils import \
        get_visualization as T
    rng = np.random.default_rng(1)
    image = rng.integers(0, 255, (32, 40, 3), dtype=np.uint8)
    mask = rng.integers(0, 3, (32, 40)).astype(np.uint8)
    layer = rng.integers(0, 255, (32, 40, 4), dtype=np.uint8)
    np.testing.assert_array_equal(T(mode, image, mask, layer, [1]),
                                  J(mode, image, mask, layer, [1]))


def test_frame_and_mask_conversions():
    from xmem2_tpu.interactive import interactive_utils as J
    from xmem2_tpu_torch.interactive import interactive_utils as T
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    norm, raw = T.image_to_torch(frame, 'cpu')
    jnorm, jraw = J.image_to_jax(frame)
    np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm), atol=1e-6)
    np.testing.assert_allclose(raw.numpy(), np.asarray(jraw), atol=1e-7)
    prob = rng.random((3, 20, 30)).astype(np.float32)
    ref = J.prob_to_numpy_mask(prob)
    np.testing.assert_array_equal(T.prob_to_numpy_mask(prob), ref)
    np.testing.assert_array_equal(
        T.prob_to_numpy_mask(torch.from_numpy(prob)), ref)
    np.testing.assert_array_equal(T.index_numpy_to_one_hot(ref, 3),
                                  J.index_numpy_to_one_hot(ref, 3))


@pytest.mark.parametrize('align_corners', [False, True])
@pytest.mark.parametrize('src,dst', [((13, 17), (40, 51)),
                                     ((40, 51), (13, 17)),
                                     ((16, 24), (64, 96)),
                                     ((30, 45), (30, 20))])
def test_resize_bilinear_conventions(align_corners, src, dst):
    """nn.functional.resize_bilinear against the JAX package's, both
    conventions, up- and downscales with ragged sizes: within 1e-5."""
    from xmem2_tpu.nn.functional import resize_bilinear as J
    from xmem2_tpu_torch.nn.functional import resize_bilinear as T
    x = np.random.default_rng(3).standard_normal((2, 3) + src) \
        .astype(np.float32)
    ref = np.asarray(J(jnp.asarray(np.moveaxis(x, 1, -1)), dst,
                       align_corners=align_corners))
    ours = T(torch.from_numpy(x), dst, align_corners=align_corners).numpy()
    np.testing.assert_allclose(ours, np.moveaxis(ref, -1, 1), atol=1e-5)


# --------------------------------------------------------- cv2 substitutes

def _strokes(rng, n, h, w, inside):
    for i in range(n):
        th = int(rng.choice([1, 2, 3, 4, 5, 7, 10, 17, 30]))
        if inside:
            p0 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            p1 = (int(rng.integers(0, w)), int(rng.integers(0, h))) \
                if i % 2 else (min(w - 1, max(0, p0[0] + int(
                    rng.integers(-6, 7)))),
                    min(h - 1, max(0, p0[1] + int(rng.integers(-6, 7)))))
        else:
            p0 = (int(rng.integers(-30, w + 30)),
                  int(rng.integers(-30, h + 30)))
            p1 = (p0[0] + int(rng.integers(-25, 26)),
                  p0[1] + int(rng.integers(-25, 26)))
        yield p0, p1, th


def test_line_raster_equals_cv2_inside_the_image():
    """The numpy line rasterizer sets exactly cv2.line's pixels (LINE_8)
    for 1,000 strokes of thickness 1-30 whose end points lie in the image
    (the GUI clamps its points there), thick strokes reaching past the
    border included."""
    from xmem2_tpu_torch.interactive.raster import line_mask
    rng = np.random.default_rng(4)
    h, w = 64, 96
    for p0, p1, th in _strokes(rng, 1000, h, w, inside=True):
        ref = cv2.line(np.zeros((h, w), np.uint8), p0, p1, 1, thickness=th)
        np.testing.assert_array_equal(line_mask((h, w), p0, p1, th),
                                      ref.astype(bool),
                                      err_msg=f'{p0} {p1} {th}')


def test_line_raster_outside_points_rim_pixels():
    """End points outside the image: cv2 clips the outline in fixed point
    and differs from the rasterizer on a few rim pixels. Stated bound over
    500 strokes: at most 12% of strokes differ, by at most 25 pixels
    (measured: ~10% and up to 20)."""
    from xmem2_tpu_torch.interactive.raster import line_mask
    rng = np.random.default_rng(5)
    h, w = 64, 96
    differ = []
    for p0, p1, th in _strokes(rng, 500, h, w, inside=False):
        ref = cv2.line(np.zeros((h, w), np.uint8), p0, p1, 1, thickness=th)
        differ.append(int((line_mask((h, w), p0, p1, th)
                           != ref.astype(bool)).sum()))
    differ = np.array(differ)
    assert (differ > 0).mean() <= 0.12 and differ.max() <= 25, \
        ((differ > 0).mean(), differ.max())


def test_disc_and_canvas_types_equal_cv2():
    """Filled circles (the click marks) byte-equal to cv2.circle at radii
    0-11, also clipped at the border; draw_line on float and 3-channel
    canvases paints like cv2 (the GUI's vis_alpha and vis_map)."""
    from xmem2_tpu_torch.interactive.raster import draw_disc, draw_line
    rng = np.random.default_rng(6)
    h, w = 48, 64
    for _ in range(300):
        c = (int(rng.integers(-5, w + 5)), int(rng.integers(-5, h + 5)))
        r = int(rng.integers(0, 12))
        ref = cv2.circle(np.zeros((h, w), np.uint8), c, r, 1, thickness=-1)
        np.testing.assert_array_equal(
            draw_disc(np.zeros((h, w), np.uint8), c, r, 1), ref)
    alpha = draw_line(np.zeros((h, w), np.float32), (3.4, 5.6), (40.5, 30.2),
                      0.75, 3)
    ref = cv2.line(np.zeros((h, w), np.float32), (3, 6), (40, 30), 0.75,
                   thickness=3)
    np.testing.assert_array_equal(alpha, ref)
    colour = [10, 200, 30]
    vis = draw_line(np.zeros((h, w, 3), np.uint8), (5, 5), (50, 40), colour,
                    5)
    ref = cv2.line(np.zeros((h, w, 3), np.uint8), (5, 5), (50, 40), colour,
                   thickness=5)
    np.testing.assert_array_equal(vis, ref)


@pytest.mark.parametrize('src,dst', [((96, 160), (48, 80)),
                                     ((100, 171), (48, 82)),
                                     ((270, 480), (120, 213)),
                                     ((64, 96), (96, 144)),
                                     ((50, 70), (81, 113))])
def test_area_resize_within_one_step_of_cv2(src, dst):
    """resize_area_np against cv2.resize(INTER_AREA), down- and upscales:
    every value within one step of cv2's, at most 10% of them off."""
    from xmem2_tpu_torch.utils.resize_np import resize_area_np
    img = np.random.default_rng(7).integers(0, 256, src + (3,)) \
        .astype(np.uint8)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    d = np.abs(resize_area_np(img, dst).astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.10


# ---------------------------------------------------------------- dist maps

POINTS = np.array([[10.4, 20.6], [30, 5], [-1, -1],
                   [50.5, 80.5], [3, 90], [-1, -1]], np.float32)


def test_dist_maps_native_numpy_and_jax():
    """The native BFS (the port's copy of the source, built into build/)
    equals the numpy BFS and the JAX package's native BFS exactly; the
    tensor formula is within 1e-6 of the JAX formula; Clicker packing is
    the JAX package's."""
    from xmem2_tpu.interactive.clicks import dist_maps as J
    from xmem2_tpu_torch.interactive.clicks import dist_maps as T
    ours = T.get_dist_maps_native(POINTS, 64, 96, 260.0)
    np.testing.assert_array_equal(ours, T._bfs_numpy(POINTS, 64, 96, 260.0))
    np.testing.assert_array_equal(
        ours, J.get_dist_maps_native(POINTS, 64, 96, 260.0))
    np.testing.assert_allclose(
        T.dist_maps_torch(POINTS, 64, 96, 260.0).numpy(),
        np.asarray(J.dist_maps_jax(POINTS, 64, 96, 260.0)), atol=1e-6)
    so = T.library_path()
    assert so.parent == REPO / 'build' and so.exists()
    jc, tc = J.Clicker(), T.Clicker()
    for pos, rc in ((True, (3, 4)), (False, (5, 6)), (True, (7, 8))):
        jc.add_click(J.Click(pos, rc))
        tc.add_click(T.Click(pos, rc))
    np.testing.assert_array_equal(tc.to_points(), jc.to_points())
    np.testing.assert_array_equal(tc.to_points(max_clicks=4),
                                  jc.to_points(max_clicks=4))


def test_clicks_outside_the_image_count_as_absent():
    """A click outside the image (a negative click outside f-BRS's zoom-in
    crop) is dropped; the JAX package passes it to the BFS, which writes
    outside its buffer."""
    from xmem2_tpu_torch.interactive.clicks import dist_maps as T
    pts = np.array([[10, 10], [70, 3], [20, -3], [5, 200]], np.float32)
    ours = T.get_dist_maps_native(pts, 64, 96, 260.0)
    inside = np.array([[10, 10], [-1, -1], [-1, -1], [-1, -1]], np.float32)
    np.testing.assert_array_equal(
        ours, T.get_dist_maps_native(inside, 64, 96, 260.0))
    assert ours[1].min() == 1e6


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ cannot compile raises RuntimeError; the port never
    falls back to the numpy BFS on its own."""
    from xmem2_tpu_torch.interactive.clicks import dist_maps as T
    bad = tmp_path / 'dist_maps.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(T, 'SOURCE', bad)
    monkeypatch.setattr(T, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(T, '_lib', None)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        T.get_dist_maps_native(POINTS, 8, 8, 260.0)
    assert not list((tmp_path / 'build').glob('*.so'))


# -------------------------------------------------------------- aggregation

@pytest.mark.parametrize('name', ['aggregate_sbg', 'aggregate_wbg'])
@pytest.mark.parametrize('keep_bg,hard', [(False, False), (True, True)])
def test_aggregation(name, keep_bg, hard):
    from xmem2_tpu.interactive import interaction as J
    from xmem2_tpu_torch.interactive import interaction as T
    prob = np.random.default_rng(8).random((2, 12, 16)).astype(np.float32)
    ref = np.asarray(getattr(J, name)(jnp.asarray(prob), keep_bg=keep_bg,
                                      hard=hard))
    ours = getattr(T, name)(torch.from_numpy(prob), keep_bg=keep_bg,
                            hard=hard).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)


# ------------------------------------------------------------- interactions

class _FixedS2M:
    def __init__(self, prob, to):
        self.prob, self.to = prob, to
        self.seen = None

    def interact(self, image, prev_mask, scr):
        self.seen = np.array(scr)
        return self.to(self.prob)


def _stroke_pairs(j, t, points, labels):
    for (x, y), k in zip(points, labels):
        j.push_point(x, y, k)
        t.push_point(x, y, k)


def test_free_and_scribble_interactions_match_jax():
    """Brush strokes (several paths, brush size 7) and scribbles draw the
    same index maps as the JAX package's cv2 strokes; the predictions
    (one-hot, and S2M probabilities through aggregate_wbg) agree."""
    from xmem2_tpu.interactive import interaction as J
    from xmem2_tpu_torch.interactive import interaction as T
    h, w = 48, 64
    prev = np.zeros((h, w), np.uint8)
    prev[5:15, 5:20] = 2
    pts = [(5.2, 5.7), (20.4, 9.1), (33.0, 30.0), (40.6, 31.2), (12, 40)]
    jf = J.FreeInteraction(None, prev, (h, w), 2)
    tf = T.FreeInteraction(None, prev, (h, w), 2)
    for it in (jf, tf):
        it.set_size(7)
    _stroke_pairs(jf, tf, pts, [1, 1, 1, 2, 2])
    jf.end_path()
    tf.end_path()
    _stroke_pairs(jf, tf, pts[::-1], [0, 0, 1, 1, 1])
    np.testing.assert_array_equal(tf.drawn_map, jf.drawn_map)
    np.testing.assert_array_equal(tf.predict().numpy(),
                                  np.asarray(jf.predict()))

    prob = np.random.default_rng(9).random((2, h, w)).astype(np.float32)
    jctrl, tctrl = _FixedS2M(prob, jnp.asarray), _FixedS2M(
        prob, torch.from_numpy)
    js = J.ScribbleInteraction(None, prev, (h, w), jctrl, 2)
    ts = T.ScribbleInteraction(None, prev, (h, w), tctrl, 2)
    _stroke_pairs(js, ts, pts, [1, 1, 2, 2, 2])
    ref, ours = np.asarray(js.predict()), ts.predict().numpy()
    np.testing.assert_array_equal(tctrl.seen, jctrl.seen)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_click_interaction_and_vis_match_jax():
    """ClickInteraction with a fixed click controller: the aggregated
    prediction and the click marks drawn on the GUI's vis map and alpha
    equal the JAX package's."""
    from xmem2_tpu.interactive import interaction as J
    from xmem2_tpu_torch.interactive import interaction as T
    h, w = 40, 56
    obj = np.zeros((h, w), np.float32)
    obj[10:30, 10:40] = 1

    class Clicks:
        def __init__(self, to):
            self.to = to

        def interact(self, image, x, y, positive):
            return self.to(obj)

    prev = np.eye(3, dtype=np.float32)[np.random.default_rng(10).integers(
        0, 3, (h, w))].transpose(2, 0, 1)
    ji = J.ClickInteraction(None, prev, (h, w), Clicks(jnp.asarray), 2)
    ti = T.ClickInteraction(None, prev, (h, w), Clicks(torch.from_numpy), 2)
    vis = [(np.zeros((h, w, 3), np.uint8), np.zeros((h, w), np.float32))
           for _ in range(2)]
    for x, y, neg in ((20.4, 15.6, False), (1.0, 39.0, True)):
        jv = ji.push_point(x, y, neg, vis=vis[0])
        tv = ti.push_point(x, y, neg, vis=vis[1])
        for a, b in zip(tv, jv):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ti.predict().numpy(),
                               np.asarray(ji.predict()), atol=1e-6)


# ---------------------------------------------------------------- workspace

def _frames(root: Path, n=5, hw=(48, 64), ext='.jpg'):
    rng = np.random.default_rng(11)
    frames = root / 'frames'
    frames.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, hw + (3,), dtype=np.uint8)) \
            .save(frames / f'{i:05d}{ext}')
    return frames


def _managers(tmp_path, frames, **over):
    from xmem2_tpu.interactive.resource_manager import ResourceManager as J
    from xmem2_tpu_torch.interactive.resource_manager import \
        ResourceManager as T
    out = []
    for tag, cls in (('jax', J), ('torch', T)):
        cfg = {'images': str(frames), 'video': None,
               'workspace': str(tmp_path / f'ws_{tag}'), 'size': -1,
               'num_objects': 2, 'buffer_size': 3}
        cfg.update(over)
        out.append(cls(cfg))
    return out


def test_resource_manager_lifecycle(tmp_path):
    """Workspace layout, info.json, masks, references and the LRU buffers
    as in the JAX package (size -1 copies the frames); the key cache keeps
    tensors channels-last on their device."""
    frames = _frames(tmp_path)
    jrm, trm = _managers(tmp_path, frames)
    assert (len(trm), trm.h, trm.w, trm.num_objects) == \
        (len(jrm), jrm.h, jrm.w, jrm.num_objects) == (5, 48, 64, 2)
    assert trm.names == jrm.names
    for i in range(5):
        np.testing.assert_array_equal(trm.get_image(i), jrm.get_image(i))
    mask = np.zeros((48, 64), np.uint8)
    mask[10:20, 10:30] = 2
    for rm in (jrm, trm):
        rm.save_mask(2, mask)
        rm.add_reference(2)
        rm.add_reference(4)
        rm.remove_reference(4)
    np.testing.assert_array_equal(trm.get_mask(2), jrm.get_mask(2))
    assert trm.get_mask(1) is None
    info = [json.loads((Path(rm.workspace) / 'info.json').read_text())
            for rm in (jrm, trm)]
    assert info[0] == info[1] == {'references': [2], 'num_objects': 2}
    assert len(trm.get_image.cache) <= 3       # buffer_size

    _, trm2 = _managers(tmp_path, frames, num_objects=None)
    assert trm2.references == {2} and trm2.num_objects == 2
    np.testing.assert_array_equal(trm2.get_mask(2), mask)

    key = torch.arange(3 * 4 * 8, dtype=torch.float32).reshape(1, 3, 4, 8)
    for ti in range(5):
        assert not trm.all_masks_present()
        trm.add_key_and_stuff_with_mask(ti, key * ti, key[..., :1], key,
                                        np.zeros((2, 3, 4), np.float32))
    assert trm.all_masks_present()
    assert torch.is_tensor(trm.keys) and trm.keys.shape == (5, 3, 4, 8)
    assert torch.equal(trm.keys[3], key[0] * 3)
    assert trm.small_masks.shape == (5, 2, 3, 4)

    viz = np.zeros((48, 64, 3), np.uint8)
    trm.save_visualization(1, viz)
    assert (Path(trm.workspace) / 'visualization' / '00001.jpg').exists()
    ext = tmp_path / 'ext.png'
    Image.fromarray(np.where(mask > 0, 255, 0).astype(np.uint8)
                    ).convert('RGB').save(ext)
    np.testing.assert_array_equal(
        trm.read_external_image(str(ext), size=(24, 32), force_mask=True),
        jrm.read_external_image(str(ext), size=(24, 32), force_mask=True))


def test_resource_manager_resizes_like_cv2(tmp_path):
    """size > 0: the frames are resized to the shorter side with the numpy
    INTER_AREA filter; against the JAX package's cv2 path (cv2 JPEG writer
    there, PIL here, both quality 95) the decoded frames have the same
    shape and differ by JPEG noise only (mean absolute difference < 2)."""
    frames = _frames(tmp_path, n=2, hw=(100, 170))
    jrm, trm = _managers(tmp_path, frames, size=48)
    assert (trm.h, trm.w) == (jrm.h, jrm.w) == (48, 81)
    for i in range(2):
        a = trm._get_image_unbuffered(i).astype(int)
        b = jrm._get_image_unbuffered(i).astype(int)
        assert np.abs(a - b).mean() < 2.0


def test_video_input_needs_cv2(tmp_path, monkeypatch):
    """--video reads through cv2, imported only there: without it the port
    raises a clear error."""
    from xmem2_tpu_torch.interactive.resource_manager import ResourceManager
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(RuntimeError, match='cv2'):
        ResourceManager({'images': None, 'video': str(tmp_path / 'v.mp4'),
                         'workspace': str(tmp_path / 'ws'), 'size': -1})


def test_import_existing_matches_root_script(tmp_path):
    """python -m xmem2_tpu_torch.import_existing writes the same workspace
    tree, byte for byte, as the root import_existing.py run as a
    subprocess: resized frames, palette masks, info.json."""
    rng = np.random.default_rng(12)
    imgs, masks = tmp_path / 'imgs', tmp_path / 'masks'
    imgs.mkdir()
    masks.mkdir()
    colours = np.array([[0, 0, 0], [250, 20, 20], [20, 250, 20]], np.uint8)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (60, 90, 3), dtype=np.uint8)) \
            .save(imgs / f'{i:04d}.jpg')
        Image.fromarray(colours[rng.integers(0, 3, (60, 90))]).save(
            masks / f'{i:04d}.png')
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS='cpu')
    trees = {}
    for tag, cmd in (('root', [str(REPO / 'import_existing.py')]),
                     ('port', ['-m', 'xmem2_tpu_torch.import_existing'])):
        cwd = tmp_path / tag
        cwd.mkdir()
        out = subprocess.run(
            [sys.executable, *cmd, '--name', 'proj', '--size', '40',
             '--images', str(imgs), '--masks', str(masks)],
            cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        root = cwd / 'workspace' / 'proj'
        trees[tag] = {str(p.relative_to(root)): p.read_bytes()
                      for p in sorted(root.rglob('*')) if p.is_file()}
    assert len(trees['port']) == 7
    assert trees['port'] == trees['root']
