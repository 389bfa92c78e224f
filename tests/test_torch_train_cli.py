"""python -m xmem2_tpu_torch.train --device cpu end to end: stage 0 (static
images, single object) then stage 2 (DAVIS + YouTubeVOS layouts, three
objects) for 2 iterations each at crop 64, with the in-memory handoff
between them. The saved networks load in the port's load_model and in the
JAX package's load_any, and --stats records finite losses."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from xmem2_tpu.bridge.torch_params import load_any
from xmem2_tpu_torch.bridge.torch_params import load_model

REPO = Path(__file__).resolve().parents[1]
PALETTE = [0, 0, 0, 128, 0, 0, 0, 128, 0, 0, 0, 128] + [0] * 756


def frame(h, w, t):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 3 + t * 5) % 256, (yy * 2) % 256,
                    (xx + yy) % 256], -1).astype(np.uint8)
    m = np.zeros((h, w), np.uint8)
    m[h // 4 + t:h // 2 + t, w // 4:w // 2] = 1
    m[h // 2:3 * h // 4, w // 2 + t:3 * w // 4 + t] = 2
    m[2:h // 5, 2:w // 5] = 3
    return img, m


@pytest.fixture(scope='module')
def roots(tmp_path_factory):
    """The reference layouts: static/{fss/<class>, DUTS-TR, ...}, DAVIS
    2017/trainval/{JPEGImages,Annotations}/480p and YouTube
    train_480p/{JPEGImages,Annotations}, with whitelisted video names."""
    root = tmp_path_factory.mktemp('train_cli')
    h, w = 96, 128
    st = root / 'static'
    for c in ('a', 'b'):
        (st / 'fss' / c).mkdir(parents=True)
        for i in (1, 2):
            img, m = frame(h, w, i)
            Image.fromarray(img).save(st / 'fss' / c / f'{i}.jpg')
            Image.fromarray((m > 0).astype(np.uint8) * 255).save(
                st / 'fss' / c / f'{i}.png')
    for name in ('DUTS-TR', 'DUTS-TE', 'ecssd', 'BIG_small', 'HRSOD_small'):
        (st / name).mkdir()
    davis = root / 'DAVIS' / '2017' / 'trainval'
    yv = root / 'YouTube' / 'train_480p'
    for base, vids, sub in ((davis, ('bear', 'bmx-bumps'), '480p'),
                            (yv, ('003234408d',), '')):
        for v in vids:
            ims = base / 'JPEGImages' / sub / v
            anns = base / 'Annotations' / sub / v
            ims.mkdir(parents=True)
            anns.mkdir(parents=True)
            for t in range(6):
                img, m = frame(h, w, t)
                Image.fromarray(img).save(ims / f'{t:05d}.jpg')
                pm = Image.fromarray(m, mode='P')
                pm.putpalette(PALETTE)
                pm.save(anns / f'{t:05d}.png')
    return root


@pytest.fixture(scope='module')
def run(roots):
    """Both stages in one process (the handoff is in memory), each saving
    its network after step 1."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='2')
    out = subprocess.run(
        [sys.executable, '-m', 'xmem2_tpu_torch.train', '--device', 'cpu',
         '--stages', '02', '--static_root', 'static', '--davis_root',
         'DAVIS', '--yv_root', 'YouTube', '--crop_size', '64',
         '--num_workers', '1', '--s0_batch_size', '2', '--s0_iterations',
         '2', '--s2_batch_size', '2', '--s2_iterations', '2',
         '--s2_finetune', '0', '--s2_num_frames', '3',
         '--s2_num_ref_frames', '2', '--exp_id', 'cli',
         '--save_network_interval', '1', '--log_text_interval', '1',
         '--stats', 'stats.json'],
        cwd=roots, env=env, capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    return out


def test_stages_run_and_hand_over(run):
    assert 'Starting stage 0' in run.stdout
    assert '4 images found.' in run.stdout
    assert 'Starting stage 2' in run.stdout
    assert 'Loading network from the previous stage' in run.stdout
    assert '2 out of 2 videos accepted' in run.stdout


def test_saved_networks_load_in_both_packages(run, roots):
    saves = sorted((roots / 'saves').rglob('*.pth'))
    s0 = [p for p in saves if p.parent.name.endswith('_cli_s0')]
    s02 = [p for p in saves if p.parent.name.endswith('_cli_s02')]
    assert len(s0) == 1 and len(s02) == 1, saves
    for path, channels in ((s0[0], 4), (s02[0], 5)):
        sd = torch.load(path, map_location='cpu', weights_only=True)
        assert sd['value_encoder.conv1.weight'].shape[1] == channels
        model = load_model(str(path), device='cpu')
        assert model.value_encoder.conv1.weight.shape[1] == 5
        np.testing.assert_array_equal(
            model.value_encoder.conv1.weight[:, :channels].numpy(),
            sd['value_encoder.conv1.weight'].numpy())
        jparams = load_any(str(path))
        np.testing.assert_array_equal(
            np.asarray(jparams.tree['decoder']['pred']['bias']),
            sd['decoder.pred.bias'].numpy())


def test_stats_record_finite_losses(run, roots):
    stats = json.loads((roots / 'stats.json').read_text())
    assert [s['stage'] for s in stats] == ['0', '2']
    for s in stats:
        assert len(s['losses']) == 2
        assert np.isfinite(s['losses']).all()
        assert s['fresh_loader_steps'][0] == 0
