"""The port stands alone: no module of xmem2_tpu_torch, nor chip_smoke.py,
imports JAX or anything of xmem2_tpu, and its entry points never fall back
to the CPU on their own."""

import os
import subprocess
import sys
from pathlib import Path

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
    from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG
    from xmem2_tpu_torch.inference.core import InferenceCore
    from xmem2_tpu_torch.inference.net import XMemNet
    from xmem2_tpu_torch.inference.run_on_video import run_on_video
    from xmem2_tpu_torch.models.network import XMem

    with pytest.raises(RuntimeError, match='CUDA'):
        XMemNet(XMem(key_dim=8, value_dim=16, hidden_dim=4))
    net = XMemNet(XMem(key_dim=8, value_dim=16, hidden_dim=4), device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        InferenceCore(net, dict(VIDEO_INFERENCE_CONFIG))
    with pytest.raises(RuntimeError, match='CUDA'):
        run_on_video(tmp_path, tmp_path, tmp_path / 'out')


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


def test_unported_options_raise():
    from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG
    from xmem2_tpu_torch.memory.manager import MemoryManager
    for over in ({'memory_shards': 2}, {'spill_long_term': True}):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            MemoryManager(dict(VIDEO_INFERENCE_CONFIG, **over), device='cpu')
