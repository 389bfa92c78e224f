"""The port stands alone: no module of xmem2_tpu_torch, nor chip_smoke.py,
imports JAX or anything of xmem2_tpu, and its entry points never fall back
to the CPU on their own."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def _run(code: str) -> subprocess.CompletedProcess:
    """Python in a fresh process where `import jax` fails."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, '-c', "import sys; sys.modules['jax'] = None\n"
         + code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)


def test_every_module_imports_without_jax():
    out = _run("""
import importlib, pkgutil
import xmem2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(xmem2_tpu_torch.__path__,
                                               'xmem2_tpu_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == 'xmem2_tpu' or m.startswith('xmem2_tpu.'))
assert not bad, bad
assert len(names) > 20, names
missing = {'xmem2_tpu_torch.eval', 'xmem2_tpu_torch.run_experiments',
           'xmem2_tpu_torch.memory.spill', 'xmem2_tpu_torch.utils.metrics',
           'xmem2_tpu_torch.inference.data.test_datasets',
           'xmem2_tpu_torch.inference.frame_selection.frame_selection',
           'xmem2_tpu_torch.inference.frame_selection.utils',
           'xmem2_tpu_torch.models.init', 'xmem2_tpu_torch.train.cli',
           'xmem2_tpu_torch.train.trainer', 'xmem2_tpu_torch.train.losses',
           'xmem2_tpu_torch.train.vos_dataset',
           'xmem2_tpu_torch.train.static_dataset',
           'xmem2_tpu_torch.train.loader', 'xmem2_tpu_torch.utils.logger',
           'xmem2_tpu_torch.utils.load_subset'} - set(names)
assert not missing, missing
print('imported', len(names))
""")
    assert out.returncode == 0, out.stderr
    assert 'imported' in out.stdout


def test_chip_smoke_needs_a_card_and_no_jax():
    """chip_smoke.py imports no JAX; without a CUDA device it exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: chip_smoke.py would run')
    out = _run("import runpy; runpy.run_path('chip_smoke.py', "
               "run_name='__main__')")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from xmem2_tpu_torch import eval as port_eval
    from xmem2_tpu_torch.bridge.torch_params import load_model
    from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG
    from xmem2_tpu_torch.inference.core import InferenceCore
    from xmem2_tpu_torch.inference.frame_selection import \
        select_next_candidates
    from xmem2_tpu_torch.inference.net import XMemNet
    from xmem2_tpu_torch.inference.run_on_video import (
        run_on_video, select_k_next_best_annotation_candidates)
    from xmem2_tpu_torch.models.network import XMem

    with pytest.raises(RuntimeError, match='CUDA'):
        XMemNet(XMem(key_dim=8, value_dim=16, hidden_dim=4))
    net = XMemNet(XMem(key_dim=8, value_dim=16, hidden_dim=4), device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        InferenceCore(net, dict(VIDEO_INFERENCE_CONFIG))
    with pytest.raises(RuntimeError, match='CUDA'):
        run_on_video(tmp_path, tmp_path, tmp_path / 'out')
    with pytest.raises(RuntimeError, match='CUDA'):
        select_k_next_best_annotation_candidates(tmp_path, tmp_path,
                                                 tmp_path / 'out')
    with pytest.raises(RuntimeError, match='CUDA'):
        select_next_candidates(np.zeros((2, 1, 1, 4)), np.ones((2, 1, 1, 1)),
                               np.ones((2, 1, 1, 4)), [np.ones((1, 4, 4))] * 2,
                               1)
    with pytest.raises(RuntimeError, match='CUDA'):
        port_eval.main(['--dataset', 'G', '--generic_path', str(tmp_path),
                        '--output', str(tmp_path / 'eval')])
    with pytest.raises(RuntimeError, match='CUDA'):
        load_model(str(tmp_path / 'ckpt.pth'))


def test_training_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    """XMemTrainer and the training CLI run on the card by default: without
    CUDA they raise; --device cpu / device='cpu' run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from xmem2_tpu_torch.models.network import XMem
    from xmem2_tpu_torch.train import cli
    from xmem2_tpu_torch.train.trainer import XMemTrainer
    dims = (8, 16, 4)
    sd = {k: v.numpy() for k, v in XMem(*dims).state_dict().items()}
    config = dict(lr=1e-5, weight_decay=0.05, start_warm=1, end_warm=2)
    with pytest.raises(RuntimeError, match='CUDA'):
        XMemTrainer(config, sd, dims)
    assert XMemTrainer(config, sd, dims, device='cpu').device == \
        torch.device('cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        cli.main(['--stages', '0', '--static_root', str(tmp_path)])


def test_memory_manager_defaults_to_cuda():
    """MemoryManager runs on the card unless asked for the CPU, like every
    other entry point: without CUDA its default raises."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG
    from xmem2_tpu_torch.memory.manager import MemoryManager

    with pytest.raises(RuntimeError, match='CUDA'):
        MemoryManager(dict(VIDEO_INFERENCE_CONFIG))
    mm = MemoryManager(dict(VIDEO_INFERENCE_CONFIG), device='cpu')
    assert mm.device == torch.device('cpu')


def test_model_loading_defaults_to_cuda(tmp_path):
    """build_model and load_model put the weights on the card unless asked
    for the CPU: without CUDA their default raises."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from xmem2_tpu_torch.bridge.torch_params import build_model, load_model
    from xmem2_tpu_torch.models.network import XMem
    dims = (8, 16, 4)
    sd = {k: v.numpy() for k, v in XMem(*dims).state_dict().items()}
    with pytest.raises(RuntimeError, match='CUDA'):
        build_model(sd, dims)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / 'ckpt.pth')
    with pytest.raises(RuntimeError, match='CUDA'):
        load_model(str(tmp_path / 'ckpt.pth'))
    model = load_model(str(tmp_path / 'ckpt.pth'), device='cpu')
    assert next(model.parameters()).device == torch.device('cpu')


@pytest.mark.parametrize('over,ported', [({'memory_shards': 2}, False),
                                         ({'spill_long_term': True}, True)])
def test_unported_options_raise(over, ported):
    """Options not ported yet raise, naming their ROADMAP item; spill is
    ported."""
    from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG
    from xmem2_tpu_torch.memory.manager import MemoryManager
    config = dict(VIDEO_INFERENCE_CONFIG, **over)
    if ported:
        assert MemoryManager(config, device='cpu').archive is not None
    else:
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            MemoryManager(config, device='cpu')
