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
    """Every module imports with JAX blocked and without cv2: none imports
    cv2 at import time. The two Qt modules (interactive/gui.py and
    interactive/gui_utils.py) import PyQt5 at module top, which neither
    machine has: they are imported under tests/qt_stub.py."""
    out = _run("""
import importlib, pkgutil
from tests import qt_stub
qt_stub.install()
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
           'xmem2_tpu_torch.utils.load_subset',
           'xmem2_tpu_torch.utils.image_loader',
           'xmem2_tpu_torch.interactive.interactive_utils',
           'xmem2_tpu_torch.interactive.raster',
           'xmem2_tpu_torch.interactive.clicks.dist_maps',
           'xmem2_tpu_torch.interactive.s2m.network',
           'xmem2_tpu_torch.interactive.s2m.controller',
           'xmem2_tpu_torch.interactive.interaction',
           'xmem2_tpu_torch.interactive.resource_manager',
           'xmem2_tpu_torch.interactive.session',
           'xmem2_tpu_torch.interactive.fbrs.model',
           'xmem2_tpu_torch.interactive.fbrs.hrnet',
           'xmem2_tpu_torch.interactive.fbrs.utils',
           'xmem2_tpu_torch.interactive.fbrs.transforms',
           'xmem2_tpu_torch.interactive.fbrs.predictor',
           'xmem2_tpu_torch.interactive.fbrs.controller',
           'xmem2_tpu_torch.interactive.gui_utils',
           'xmem2_tpu_torch.interactive.gui',
           'xmem2_tpu_torch.interactive_demo',
           'xmem2_tpu_torch.import_existing',
           'xmem2_tpu_torch.parallel.mesh',
           'xmem2_tpu_torch.parallel.sharded_readout',
           'xmem2_tpu_torch.memory.sharded_store',
           'xmem2_tpu_torch.utils.profiling',
           'xmem2_tpu_torch.merge_multi_scale'} - set(names)
assert not missing, missing
assert 'cv2' not in sys.modules
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


def test_interactive_entry_points_raise_without_cuda(tmp_path):
    """S2MController, FBRSController, a SessionController's processor and
    interactive_demo.main run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from xmem2_tpu_torch import interactive_demo
    from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG
    from xmem2_tpu_torch.inference.core import InferenceCore
    from xmem2_tpu_torch.inference.net import XMemNet
    from xmem2_tpu_torch.interactive.fbrs.controller import FBRSController
    from xmem2_tpu_torch.interactive.fbrs.model import FBRSModel
    from xmem2_tpu_torch.interactive.s2m import S2MController, S2MNet
    from xmem2_tpu_torch.models.network import XMem

    s2m = {k: v.numpy() for k, v in S2MNet(8, 8, 16, 8).state_dict().items()}
    with pytest.raises(RuntimeError, match='CUDA'):
        S2MController(s2m, 1)
    torch.save(FBRSModel(8, 8, 16).state_dict(), tmp_path / 'fbrs.pth')
    with pytest.raises(RuntimeError, match='CUDA'):
        FBRSController(str(tmp_path / 'fbrs.pth'))
    net = XMemNet(XMem(key_dim=8, value_dim=16, hidden_dim=4), device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        InferenceCore(net, dict(VIDEO_INFERENCE_CONFIG))   # the processor
    with pytest.raises(RuntimeError, match='CUDA'):
        interactive_demo.main(['--images', str(tmp_path)])


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
    """Every option of the JAX package is ported now: memory_shards builds
    a sharded manager (two shards on the CPU), spill_long_term an archive
    (`ported`: whether the option is the spill)."""
    from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG
    from xmem2_tpu_torch.memory.manager import MemoryManager
    mm = MemoryManager(dict(VIDEO_INFERENCE_CONFIG, **over), device='cpu')
    assert (mm.archive is not None) == ported
    assert mm.sharded == (not ported)
    if mm.sharded:
        assert mm.shard_devices == [torch.device('cpu')] * 2


def test_memory_devices_need_enough_cards():
    """memory_devices raises when fewer CUDA devices are visible than
    shards (as JAX memory_mesh does), so a sharded manager on the card does
    too unless shard_devices places the shards; on the CPU every shard is
    the CPU."""
    from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG
    from xmem2_tpu_torch.memory.manager import MemoryManager
    from xmem2_tpu_torch.parallel.mesh import memory_devices
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match='visible'):
        memory_devices(n, 'cuda')
    assert memory_devices(3, 'cpu') == [torch.device('cpu')] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            MemoryManager(dict(VIDEO_INFERENCE_CONFIG, memory_shards=n))
