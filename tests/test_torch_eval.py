"""The port's evaluation surface against xmem2_tpu and the root scripts, on
the CPU:

  - J and F (utils/metrics.py) equal to the JAX package's;
  - the dataset listings (inference/data/test_datasets.py) equal on
    synthetic DAVIS, YouTube-VOS, long-video and generic layouts;
  - `xmem2_tpu_torch.eval` on a synthetic generic dataset (two 64x96
    videos, frames resized to 48 on the shorter side, memory settings under
    which long-term memory consolidates) equal to the root eval.py on the
    same data, f32: palette PNGs equal up to 0.1% of pixels (argmax
    near-ties under another float32 summation order, as in
    test_torch_run_on_video.py), and the uint8 scores (prob * 255,
    truncated) at most one step apart on at most 5.1% of entries, which is
    what probabilities within 1e-4 of each other allow (255 * 1e-4 of the
    unit interval sits within 1e-4 of a step);
  - `xmem2_tpu_torch.run_experiments` with all three selectors, and its
    compute_metrics equal to the root script's.

The root eval.py runs in this process on its per-frame path
(XMEM2_FAST_STEP=0, --no_chunked)."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_run_on_video import (  # noqa: F401
    one_torch_thread, synth_params, write_video)

REPO = Path(__file__).resolve().parents[1]
MEMORY_FLAGS = ['--size', '48', '--exact', '--mem_every', '2',
                '--max_mid_term_frames', '4', '--min_mid_term_frames', '2',
                '--num_prototypes', '16', '--max_long_term_elements', '24']


def _root_module(name):
    spec = importlib.util.spec_from_file_location(f'root_{name}',
                                                  REPO / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _label_masks(rng, n=4, h=40, w=52, objects=3):
    y = np.zeros((n, h, w), np.uint8)
    for o in range(1, objects + 1):
        for i in range(n):
            cy, cx = rng.integers(5, h - 5), rng.integers(5, w - 5)
            y[i, max(cy - 8, 0):cy + 8, max(cx - 10, 0):cx + 10] = o
    return y


@pytest.mark.parametrize('seed', [0, 1])
def test_metrics_equal_jax(seed):
    from xmem2_tpu.utils import metrics as JM
    from xmem2_tpu_torch.utils import metrics as TM
    rng = np.random.default_rng(seed)
    y_true, y_pred = _label_masks(rng), _label_masks(rng)
    y_pred[1] = 0                     # an empty prediction
    for fn in ('batched_jaccard', 'batched_f_measure'):
        for avg in (True, False):
            np.testing.assert_array_equal(
                getattr(TM, fn)(y_true, y_pred, average_over_objects=avg),
                getattr(JM, fn)(y_true, y_pred, average_over_objects=avg))
    assert TM.f_measure(y_true[0] == 1, y_pred[0] == 1, bound_th=2) == \
        JM.f_measure(y_true[0] == 1, y_pred[0] == 1, bound_th=2)


def _frames(d, names, size=(24, 32)):
    d.mkdir(parents=True, exist_ok=True)
    for n in names:
        Image.new('RGB', size[::-1]).save(d / f'{n}.jpg')


def _mask(d, name, size=(24, 32)):
    d.mkdir(parents=True, exist_ok=True)
    m = Image.fromarray(np.zeros(size, np.uint8), mode='P')
    m.putpalette([0, 0, 0, 128, 0, 0] + [0] * 762)
    m.save(d / f'{name}.png')


@pytest.fixture(scope='module')
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp('layouts')
    names = [f'{i:05d}' for i in range(3)]
    for vid in ('bear', 'cat'):
        for res in ('480p', 'Full-Resolution'):
            _frames(root / 'davis' / 'JPEGImages' / res / vid, names)
            _mask(root / 'davis' / 'Annotations' / res / vid, names[0])
        _frames(root / 'yt' / 'all_frames' / 'valid_all_frames' /
                'JPEGImages' / vid, names)
        _mask(root / 'yt' / 'valid' / 'Annotations' / vid, names[0])
        for d in ('lv', 'generic'):
            _frames(root / d / 'JPEGImages' / vid, names)
            _mask(root / d / 'Annotations' / vid, names[0])
            _mask(root / d / 'Annotations' / vid, names[2])
    (root / 'davis' / 'ImageSets' / '2017').mkdir(parents=True)
    (root / 'davis' / 'ImageSets' / '2017' / 'val.txt').write_text(
        'cat\nbear\n\n')
    meta = {'videos': {v: {'objects': {'1': {'frames': ['00000', '00002']},
                                       '2': {'frames': ['00002']}}}
                       for v in ('bear', 'cat')}}
    (root / 'yt' / 'valid' / 'meta.json').write_text(json.dumps(meta))
    return root


@pytest.mark.parametrize('kind', ['davis480', 'davis_full', 'youtube',
                                  'long', 'generic'])
def test_dataset_listings_equal_jax(layouts, kind):
    from xmem2_tpu.inference.data import test_datasets as JD
    from xmem2_tpu_torch.inference.data import test_datasets as TD

    def make(mod):
        root = str(layouts)
        return {
            'davis480': lambda: mod.DAVISTestDataset(root + '/davis',
                                                     size=480),
            'davis_full': lambda: mod.DAVISTestDataset(root + '/davis',
                                                       size=-1),
            'youtube': lambda: mod.YouTubeVOSTestDataset(root + '/yt',
                                                         'valid'),
            'long': lambda: mod.LongTestDataset(root + '/lv'),
            'generic': lambda: mod.GenericTestDataset(root + '/generic'),
        }[kind]()

    def listing(ds):
        return [(r.vid_name, r.image_dir, r.mask_dir, r.size_dir, r.size,
                 r.use_all_masks, sorted(r.to_save or []), r.frames,
                 len(r), r[0].save, r[2].save, r[2].mask is not None)
                for r in ds.get_datasets()]

    jd, td = make(JD), make(TD)
    assert len(td) == len(jd) == 2
    assert listing(td) == listing(jd)


@pytest.fixture(scope='module')
def generic(tmp_path_factory):
    """Two videos in the generic layout: 16 frames with annotations on
    frames 0 and 7 (a second object group), and the first 10 frames of the
    same with the frame-0 annotation only; a checkpoint in the JAX
    format."""
    root = tmp_path_factory.mktemp('generic')
    imgs, anns = write_video(root)
    for vid, n, ann in (('two', 16, ('000000', '000007')),
                        ('one', 10, ('000000',))):
        (root / 'JPEGImages' / vid).mkdir(parents=True)
        (root / 'Annotations' / vid).mkdir(parents=True)
        for t in range(n):
            shutil.copy(imgs / f'frame_{t:06d}.jpg',
                        root / 'JPEGImages' / vid)
        for a in ann:
            shutil.copy(anns / f'frame_{a}.png', root / 'Annotations' / vid)
    from xmem2_tpu.bridge.torch_params import convert_state_dict, save_params
    ckpt = root / 'synth.npz'
    save_params(convert_state_dict(synth_params()), str(ckpt))

    out = root / 'jax'
    root_eval = _root_module('eval')
    mp = pytest.MonkeyPatch()
    mp.setenv('XMEM2_FAST_STEP', '0')
    mp.setattr(sys, 'argv', ['eval.py', '--dataset', 'G', '--generic_path',
                             str(root), '--model', str(ckpt), '--output',
                             str(out), '--save_all', '--save_scores',
                             '--no_chunked'] + MEMORY_FLAGS)
    try:
        root_eval.main()
    finally:
        mp.undo()
    return root, ckpt


def _pngs(d):
    return {f'{p.parent.name}/{p.name}': np.asarray(Image.open(p))
            for p in sorted(d.glob('*/*.png'))}


def _assert_pngs(ours, ref):
    assert sorted(ours) == sorted(ref) and len(ref) == 26
    for name, b in ref.items():
        a = ours[name]
        assert a.shape == b.shape == (64, 96)
        assert float((a != b).mean()) <= 1e-3, name


@pytest.mark.parametrize('mode', ['scores', 'chunked'])
def test_eval_matches_root_eval(generic, mode, tmp_path):
    """--save_scores (the per-frame path with the whole probability map) and
    the default chunked path with --benchmark and --profile_dir, against
    the root eval.py's --save_scores run."""
    from xmem2_tpu_torch import eval as port_eval
    root, ckpt = generic
    out = tmp_path / 'out'
    extra = ['--save_scores'] if mode == 'scores' else [
        '--benchmark', '--profile_dir', str(tmp_path / 'trace')]
    stats = port_eval.main(['--dataset', 'G', '--generic_path', str(root),
                            '--model', str(ckpt), '--output', str(out),
                            '--save_all', '--device', 'cpu']
                           + MEMORY_FLAGS + extra)
    assert stats['frames'] == 26 and stats['fps'] > 0
    assert stats['peak_memory_mb'] is None          # not measured on a CPU
    ref_dir = root / 'jax' / 'Annotations'
    _assert_pngs(_pngs(out / 'Annotations' if mode == 'scores' else out),
                 _pngs(ref_dir))
    assert Image.open(next((ref_dir / 'one').glob('*.png'))).mode == 'P'
    if mode != 'scores':
        trace = json.loads((tmp_path / 'trace' / 'trace.json').read_text())
        assert trace['traceEvents']
        return
    for vid in ('one', 'two'):
        ours = sorted((out / 'Scores' / vid).glob('*.npz'))
        ref = sorted((root / 'jax' / 'Scores' / vid).glob('*.npz'))
        assert [p.name for p in ours] == [p.name for p in ref]
        for a, b in zip(ours, ref):
            with np.load(a) as za, np.load(b) as zb:
                pa, pb = za['prob'].astype(int), zb['prob'].astype(int)
            assert pa.shape == pb.shape and pa.shape[1:] == (64, 96)
            assert np.abs(pa - pb).max() <= 1
            assert float((pa != pb).mean()) <= 0.051, a.name
        assert json.loads((out / 'Scores' / vid / 'backward.json')
                          .read_text()) == json.loads(
            (root / 'jax' / 'Scores' / vid / 'backward.json').read_text())


def test_run_experiments(generic, tmp_path, monkeypatch):
    """All three selectors on a video with ground truth on every frame, then
    compute_metrics of the port and of the root script on the saved
    predictions."""
    from tests import test_torch_run_on_video as RV
    from xmem2_tpu_torch.run_experiments import compute_metrics, main
    _, ckpt = generic
    videos = tmp_path / 'videos' / 'two'
    videos.mkdir(parents=True)
    monkeypatch.setattr(RV, 'ANNOTATED', tuple(range(RV.N_FRAMES)))
    imgs, anns = RV.write_video(videos)
    imgs.rename(videos / 'JPEGImages')
    anns.rename(videos / 'Annotations')
    out = tmp_path / 'out'
    results = main(['--videos_root', str(tmp_path / 'videos'), '--output',
                    str(out), '--k', '3', '--model', str(ckpt), '--size',
                    '-1', '--device', 'cpu'])
    res = results['two']
    assert set(res) == {'first_frame_only', 'uniform', 'cycle_dissimilarity'}
    assert res['first_frame_only']['frames'] == [0]
    assert res['uniform']['frames'] == [0, 7, 15]
    picked = res['cycle_dissimilarity']['frames']
    assert len(set(picked)) == 3 and picked[0] == 0
    assert json.loads((out / 'results.json').read_text()) == results
    gt = tmp_path / 'gt'
    gt.mkdir()
    (gt / 'two').symlink_to(videos / 'Annotations')
    root_rx = _root_module('run_experiments')
    for sel in res:
        assert compute_metrics(str(out / sel), str(gt)) == \
            root_rx.compute_metrics(str(out / sel), str(gt))
