"""python -m xmem2_tpu_torch.merge_multi_scale against the root
merge_multi_scale.py (both as subprocesses) on the same score trees: the
same PNG files byte for byte and the same zip members. The cases of
tests/test_cli_tools.py:89-154 (two runs with a missing frame and a backward
map in the DAVIS layout; the YouTube layout without one), and the trees two
runs of the port's `eval --save_scores --device cpu` write at two scales."""

import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_eval import MEMORY_FLAGS
from tests.test_torch_run_on_video import (  # noqa: F401
    one_torch_thread, synth_params, write_video)

REPO = Path(__file__).resolve().parents[1]


def merge(port: bool, args, cwd):
    cmd = [sys.executable] + (['-m', 'xmem2_tpu_torch.merge_multi_scale']
                              if port else [str(REPO / 'merge_multi_scale.py')])
    out = subprocess.run(cmd + args, cwd=cwd, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         timeout=300)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    return out.stdout


def write_scores(run: Path, vid: str, frames: dict, backward=None):
    d = run / 'Scores' / vid
    d.mkdir(parents=True)
    for name, prob in frames.items():
        np.savez_compressed(d / f'{name}.npz', prob=prob.astype(np.uint8))
    if backward is not None:
        (d / 'backward.json').write_text(json.dumps(backward))


def assert_same_outputs(ours: Path, ref: Path, zip_ours: Path, zip_ref: Path):
    a = sorted(p.relative_to(ours) for p in ours.rglob('*.png'))
    b = sorted(p.relative_to(ref) for p in ref.rglob('*.png'))
    assert a == b and a
    for rel in a:
        assert (ours / rel).read_bytes() == (ref / rel).read_bytes(), rel
    with zipfile.ZipFile(zip_ours) as za, zipfile.ZipFile(zip_ref) as zb:
        assert sorted(za.namelist()) == sorted(zb.namelist())


@pytest.mark.parametrize('dataset', ['D', 'Y'])
def test_merge_matches_root_script(tmp_path, dataset):
    """DAVIS: two runs that disagree (the sum flips the argmax on half the
    frame), a frame only one run has, a backward map. YouTube: one run, no
    backward map, PNGs under Annotations/."""
    h = w = 8
    a = np.zeros((3, h, w), np.float32)
    a[1], a[2] = 120, 100
    b = np.zeros((3, h, w), np.float32)
    b[1, :, :w // 2] = 110
    b[2, :, w // 2:] = 200
    runs = [tmp_path / 'runA', tmp_path / 'runB']
    if dataset == 'D':
        write_scores(runs[0], 'vid1', {'00000': a, '00001': a},
                     {'2': 1, '5': 2})
        write_scores(runs[1], 'vid1', {'00000': b})
    else:
        runs = runs[:1]
        write_scores(runs[0], 'vidY', {'00000': a[:2], '00001': b[:2]})
    outs = {}
    for port in (True, False):
        out = tmp_path / ('port' if port else 'root')
        merge(port, ['--dataset', dataset, '--list'] + [str(r) for r in runs]
              + ['--output', str(out), '--num_proc', '2'], tmp_path)
        outs[port] = out
    if dataset == 'D':
        m0 = np.asarray(Image.open(outs[True] / 'vid1' / '00000.png'))
        assert set(np.unique(m0[:, :w // 2])) == {2}
        assert set(np.unique(m0[:, w // 2:])) == {5}
        zips = [Path(str(outs[p]) + '.zip') for p in (True, False)]
    else:
        assert (outs[True] / 'Annotations' / 'vidY' / '00001.png').exists()
        zips = [outs[p] / f'{outs[p].name}.zip' for p in (True, False)]
    assert_same_outputs(outs[True], outs[False], *zips)


def test_merge_port_eval_scores(tmp_path):
    """Two runs of the port's eval --save_scores on the CPU (frames resized
    to 48 and at their own 64) merged by both scripts."""
    from xmem2_tpu_torch import eval as port_eval
    imgs, anns = write_video(tmp_path)
    root = tmp_path / 'generic'
    (root / 'JPEGImages').mkdir(parents=True)
    (root / 'Annotations').mkdir(parents=True)
    (root / 'JPEGImages' / 'two').symlink_to(imgs)
    (root / 'Annotations' / 'two').symlink_to(anns)
    ckpt = tmp_path / 'synth.pth'
    torch.save({k: torch.from_numpy(v) for k, v in synth_params().items()},
               ckpt)
    runs = []
    for size in ('48', '-1'):
        run = tmp_path / f'run{size}'
        flags = list(MEMORY_FLAGS)
        flags[flags.index('--size') + 1] = size
        port_eval.main(['--dataset', 'G', '--generic_path', str(root),
                        '--model', str(ckpt), '--output', str(run),
                        '--save_scores', '--device', 'cpu'] + flags)
        assert len(list((run / 'Scores' / 'two').glob('*.npz'))) == 16
        runs.append(str(run))
    outs = [tmp_path / 'port', tmp_path / 'root']
    for port, out in zip((True, False), outs):
        merge(port, ['--dataset', 'D', '--list'] + runs + ['--output',
                                                           str(out)],
              tmp_path)
    assert len(list((outs[0] / 'two').glob('*.png'))) == 16
    assert_same_outputs(outs[0], outs[1], Path(str(outs[0]) + '.zip'),
                        Path(str(outs[1]) + '.zip'))
