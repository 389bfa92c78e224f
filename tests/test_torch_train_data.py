"""The port's training data path against xmem2_tpu: VOS and static dataset
samples for the same seed and files, the TPS warp against cv2, the loader
(worker processes: rank sharding, batches equal to the datasets read in the
main process after the workers' reseeding, determinism per seed, no draws
repeated across workers, errors and early exit), the configuration's stage
defaults, the subset lists and the logger's lazy TensorBoard import."""

import multiprocessing
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from xmem2_tpu.train import augs as JA
from xmem2_tpu.train.configuration import Configuration as JConfiguration
from xmem2_tpu.train.static_dataset import StaticTransformDataset as JStatic
from xmem2_tpu.train.vos_dataset import VOSDataset as JVOS
from xmem2_tpu.utils import load_subset as JS
from xmem2_tpu_torch.train import augs as TA
from xmem2_tpu_torch.train.configuration import Configuration
from xmem2_tpu_torch.train.loader import DataLoader, reseed
from xmem2_tpu_torch.train.static_dataset import StaticTransformDataset
from xmem2_tpu_torch.train.vos_dataset import VOSDataset
from xmem2_tpu_torch.utils import load_subset as TS

REPO = Path(__file__).resolve().parents[1]
PALETTE = [0, 0, 0, 128, 0, 0, 0, 128, 0, 0, 0, 128] + [0] * 756


def textured(h, w, t, rng):
    """A smooth frame with noise, like a photograph at these sizes."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 2 + t * 7) % 256, (yy * 3 + t) % 256,
                     (xx + yy) % 256], -1)
    return np.clip(base + rng.integers(-8, 8, base.shape), 0,
                   255).astype(np.uint8)


@pytest.fixture(scope='module')
def data_root(tmp_path_factory):
    """Two VOS videos of 8 frames with three objects (DAVIS-style palette
    PNGs) and a static set in the fss layout plus one flat folder."""
    root = tmp_path_factory.mktemp('train_data')
    rng = np.random.default_rng(0)
    h, w = 72, 96
    for vid in ('bear', 'bmx-bumps'):
        (root / 'JPEGImages' / vid).mkdir(parents=True)
        (root / 'Annotations' / vid).mkdir(parents=True)
        for t in range(8):
            Image.fromarray(textured(h, w, t, rng)).save(
                root / 'JPEGImages' / vid / f'{t:05d}.jpg')
            m = np.zeros((h, w), np.uint8)
            m[8 + t:30 + t, 10:40] = 1
            m[40:60, 50 + t:80] = 2
            m[5:20, 60:90] = 3
            pm = Image.fromarray(m, mode='P')
            pm.putpalette(PALETTE)
            pm.save(root / 'Annotations' / vid / f'{t:05d}.png')
    static = root / 'static'
    for cls in ('a', 'b'):
        (static / 'fss' / cls).mkdir(parents=True)
        for i in (1, 2):
            Image.fromarray(textured(120, 160, i, rng)).save(
                static / 'fss' / cls / f'{i}.jpg')
            m = np.zeros((120, 160), np.uint8)
            m[20 + 10 * i:90, 30:120 - 10 * i] = 255
            Image.fromarray(m).save(static / 'fss' / cls / f'{i}.png')
    (static / 'flat').mkdir()
    for i in range(2):
        Image.fromarray(textured(100, 140, 5 + i, rng)).save(
            static / 'flat' / f'im{i}.jpg')
        m = np.zeros((100, 140), np.uint8)
        m[30:70, 40:100] = 255
        Image.fromarray(m).save(static / 'flat' / f'im{i}.png')
    return root


def assert_samples_equal(got, want, rgb_atol=0.0):
    assert set(got) == set(want)
    for k in ('first_frame_gt', 'cls_gt', 'selector'):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['rgb'].dtype == want['rgb'].dtype
    np.testing.assert_allclose(got['rgb'], want['rgb'], rtol=0,
                               atol=rgb_atol)
    assert got['info'] == want['info']


@pytest.mark.parametrize('is_bl,finetune', [(False, False), (True, False),
                                            (False, True)])
def test_vos_samples_byte_equal(data_root, is_bl, finetune):
    args = (str(data_root / 'JPEGImages'), str(data_root / 'Annotations'),
            3, is_bl)
    kw = dict(num_frames=4, finetune=finetune, seed=7, crop_size=48,
              subset={'bear', 'bmx-bumps'})
    port, jax_ds = VOSDataset(*args, **kw), JVOS(*args, **kw)
    assert port.videos == jax_ds.videos
    for idx in (0, 1, 0, 1):
        assert_samples_equal(port[idx], jax_ds[idx])


def test_static_samples_equal(data_root):
    """Masks, classes and selectors byte-equal; images equal up to the TPS
    warp's resampling (1 grey level, 1/255/0.225 after normalisation;
    seen: byte-equal on these images)."""
    params = [(str(data_root / 'static' / 'fss'), 0, 1),
              (str(data_root / 'static' / 'flat'), 1, 2)]
    port = StaticTransformDataset(params, num_frames=3, max_num_obj=2,
                                  seed=3, crop_size=48)
    jax_ds = JStatic(params, num_frames=3, max_num_obj=2, seed=3,
                     crop_size=48)
    assert port.im_list == jax_ds.im_list
    for idx in range(len(port)):
        assert_samples_equal(port[idx], jax_ds[idx],
                             rgb_atol=1 / 255 / 0.225 + 1e-6)


def test_tps_warp_matches_cv2():
    """The numpy remap against cv2.remap inside random_tps_warp, on noisy
    384 x 384 images (the worst case for resampling): masks exactly equal,
    images within 1 grey level (seen: 54 values of 8.8M off by 1)."""
    rng = np.random.default_rng(0)
    for trial in range(3):
        img = Image.fromarray(rng.integers(0, 256, (384, 384, 3),
                                           dtype=np.uint8))
        mask = Image.fromarray((rng.random((384, 384)) > 0.5).astype(
            np.uint8) * 255)
        j_im, j_gt = JA.random_tps_warp(img, mask,
                                        np.random.default_rng(trial))
        t_im, t_gt = TA.random_tps_warp(img, mask,
                                        np.random.default_rng(trial))
        np.testing.assert_array_equal(np.asarray(t_gt), np.asarray(j_gt))
        diff = np.abs(np.asarray(t_im, int) - np.asarray(j_im, int))
        assert diff.max() <= 1, diff.max()


def test_remap_border_and_rounding():
    """Coordinates outside the image and on half pixels, against cv2."""
    cv2 = pytest.importorskip('cv2')
    rng = np.random.default_rng(1)
    im = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    mx = (rng.random((60, 70)) * 80 - 15).astype(np.float32)
    my = (rng.random((60, 70)) * 70 - 15).astype(np.float32)
    mx[:5] = np.round(mx[:5]) + 0.5          # nearest's half-way ties
    lin = np.abs(TA._remap_linear(im, mx, my).astype(int)
                 - cv2.remap(im, mx, my, cv2.INTER_LINEAR).astype(int))
    assert lin.max() <= 1
    np.testing.assert_array_equal(
        TA._remap_nearest(im[..., 0], mx, my),
        cv2.remap(im[..., 0], mx, my, cv2.INTER_NEAREST))


class _Items:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f'bad item {i}')
        return {'x': np.array([i]), 'info': {'i': i}}


@pytest.mark.parametrize('n,world', [(10, 2), (11, 3), (8, 1)])
def test_loader_rank_sharding(n, world):
    """Every rank gets ceil(n / world) indices of the same epoch order,
    disjoint before the padding, all of them together; batches in order."""
    per_rank = -(-n // world)
    seen = []
    for rank in range(world):
        loader = DataLoader(_Items(n), batch_size=2, num_workers=2,
                            rank=rank, world_size=world, seed=4,
                            drop_last=False)
        loader.set_epoch(1)
        idx = list(loader._indices())
        assert len(idx) == per_rank
        batches = list(loader)
        assert len(batches) == len(loader) == -(-per_rank // 2)
        got = [int(v) for b in batches for v in b['x'][:, 0]]
        assert got == idx
        seen.append(idx)
    flat = [i for r in seen for i in r]
    assert sorted(set(flat)) == list(range(n))
    assert len(flat) == per_rank * world


def test_loader_raises_dataset_errors_and_stops():
    loader = DataLoader(_Items(12, fail_at=None), batch_size=2,
                        num_workers=2, shuffle=False)
    it = iter(loader)
    next(it)
    assert len(multiprocessing.active_children()) == 2
    it.close()                              # workers stop, none left
    assert multiprocessing.active_children() == []
    loader = DataLoader(_Items(12, fail_at=5), batch_size=2, num_workers=2,
                        shuffle=False)
    with pytest.raises(ValueError, match='bad item 5'):
        list(loader)
    assert multiprocessing.active_children() == []


def _batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) and g.get('info') == w.get('info')
        for k in g:
            if k != 'info':
                a, b = np.asarray(g[k]), np.asarray(w[k])
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)


def test_process_loader_equals_main_process_reads(data_root):
    """One worker process: the batches are the VOS dataset read in the main
    process in the sampler's order after the worker's reseeding, byte for
    byte (so test_vos_samples_byte_equal covers what the workers make);
    rank 1 of 2 in epoch 2."""
    args = (str(data_root / 'JPEGImages'), str(data_root / 'Annotations'),
            3, False)
    kw = dict(num_frames=4, seed=7, crop_size=48,
              subset={'bear', 'bmx-bumps'})
    ds = VOSDataset(*args, **kw)
    loader = DataLoader(ConcatVOS([ds] * 3), batch_size=2, num_workers=1,
                        rank=1, world_size=2, seed=5)
    loader.set_epoch(2)
    got = list(loader)
    assert len(got) == 1 and got[0]['rgb'].dtype == torch.float32
    main = ConcatVOS([VOSDataset(*args, **kw)] * 3)
    reseed(main, seed=5, epoch=2, rank=1, worker_id=0)
    items = [main[int(i)] for i in loader._indices()[:2]]
    want = {k: [it[k] for it in items] if k == 'info'
            else np.stack([it[k] for it in items]) for k in items[0]}
    _batches_equal(got, [want])


class ConcatVOS:
    """The CLI's ConcatDataset shape: one dataset object several times."""

    def __init__(self, datasets):
        self.datasets = datasets
        self.sizes = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self.sizes[-1])

    def __getitem__(self, i):
        d = int(np.searchsorted(self.sizes, i, side='right'))
        return self.datasets[d][i - (int(self.sizes[d - 1]) if d else 0)]


class _Draws:
    """Each item is its index and three draws from the dataset's one
    generator, as the augmentations draw."""

    def __init__(self, n, seed=0):
        self.n = n
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'i': np.array([i]), 'draws': self.rng.random(3)}


def test_process_loader_seeded_and_no_repeated_draws():
    """Four workers: two runs of one seed give equal batches; no item
    repeats another's draws (forked workers without reseeding would all
    start from the same generator state); another epoch draws anew."""
    def run(epoch):
        loader = DataLoader(_Draws(32), batch_size=2, num_workers=4, seed=1)
        loader.set_epoch(epoch)
        return list(loader)

    a, b = run(0), run(0)
    _batches_equal(a, b)
    draws = np.concatenate([x['draws'].numpy() for x in a])
    assert len({tuple(r) for r in draws}) == len(draws) == 32
    items = sorted(int(i) for x in a for i in x['i'][:, 0])
    assert items == list(range(32))
    other = np.concatenate([x['draws'].numpy() for x in run(1)])
    assert not {tuple(r) for r in other} & {tuple(r) for r in draws}


def test_configuration_defaults_match():
    ours, theirs = Configuration(), JConfiguration()
    ours.parse(argv=[])
    theirs.parse(argv=[])
    extra = {'device', 'stats'}
    assert set(ours.args) - extra == set(theirs.args)
    for k, v in theirs.args.items():
        assert ours.args[k] == v, k
    for s in '0123':
        assert ours.get_stage_parameters(s) == theirs.get_stage_parameters(s)


def test_subset_lists_match():
    assert TS.load_sub_davis() == JS.load_sub_davis()
    assert TS.load_sub_yv() == JS.load_sub_yv()
    assert {'bear', 'bmx-bumps'} <= TS.load_sub_davis()
    assert '003234408d' in TS.load_sub_yv()


def test_logger_imports_tensorboard_only_with_an_experiment():
    code = ("import sys\n"
            "from xmem2_tpu_torch.utils.logger import TensorboardLogger\n"
            "TensorboardLogger('NULL', None).log_scalar('a', 1.0, 0)\n"
            "assert 'torch.utils.tensorboard' not in sys.modules\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
