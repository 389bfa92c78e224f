"""The port's scribble-to-mask network and controller
(xmem2_tpu_torch/interactive/s2m/) against the JAX package's on the CPU,
same weights, float32.

Weights: names and shapes from the port's S2MNet at narrow widths (stem 8,
base 8, ASPP 16, low-level 8), filled by tests/golden_utils.
synth_state_dict and saved as one .pth both packages load; the last
classifier conv is scaled by 1e-2 so the probabilities are not all 0 or 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_fbrs import nchw, scale_err, synth_pth


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def s2m(tmp_path_factory):
    """(checkpoint path, JAX tree, port network on the CPU)."""
    from xmem2_tpu.interactive.s2m.network import load_s2m_params
    from xmem2_tpu_torch.interactive.s2m.network import (
        S2MNet, build_s2m, load_s2m_state_dict)
    path = tmp_path_factory.mktemp('s2m') / 's2m.pth'
    synth_pth(S2MNet(stem=8, base=8, ch=16, low_ch=8), path,
              {'classifier.classifier.3': (1e-2, 0.0)})
    return path, load_s2m_params(str(path)), \
        build_s2m(load_s2m_state_dict(str(path)), 'cpu')


def test_state_dict_names_and_round_trip(s2m):
    """The port's module holds the reference names (backbone.*,
    classifier.*, the ASPP pooling branch at convs.4.{1,2}) and the JAX tree
    converts back to the same state dict."""
    from xmem2_tpu_torch.bridge.torch_params import tree_to_state_dict
    _, tree, model = s2m
    ours = model.state_dict()
    assert 'classifier.aspp.convs.4.1.weight' in ours
    assert 'classifier.classifier.3.bias' in ours
    assert all(k.startswith(('backbone.', 'classifier.')) for k in ours)
    assert ours['backbone.conv1.weight'].shape[1] == 6
    sd = tree_to_state_dict(tree)
    assert set(sd) == set(ours)
    for k, v in sd.items():
        np.testing.assert_array_equal(v, ours[k].numpy(), err_msg=k)


@pytest.mark.parametrize('hw', [(64, 96), (72, 88)])
def test_network_forward(s2m, hw):
    """deeplabv3plus_resnet50_apply, batch 2: logits within 1e-5 of their
    largest magnitude, also at a size not divisible by 16 (72x88)."""
    from xmem2_tpu.interactive.s2m.network import deeplabv3plus_resnet50_apply
    _, tree, model = s2m
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2,) + hw + (6,)).astype(np.float32)
    ref = np.asarray(deeplabv3plus_resnet50_apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        ours = model(nchw(x)).numpy()
    assert ours.shape == (2, 1) + hw
    assert scale_err(ours[:, 0], ref[..., 0]) < 1e-5


@pytest.mark.parametrize('hw', [(64, 96), (70, 90)])
def test_controller(s2m, hw):
    """S2MController.interact (all objects in one batch) against the JAX
    per-object loop: probabilities within 1e-3 absolute, padded to 16 and
    unpadded (70x90 is padded to 80x96)."""
    from xmem2_tpu.interactive.s2m.controller import S2MController as JS
    from xmem2_tpu_torch.interactive.s2m.controller import S2MController
    path, tree, _ = s2m
    from xmem2_tpu_torch.interactive.s2m.network import load_s2m_state_dict
    h, w = hw
    rng = np.random.default_rng(1)
    image = rng.standard_normal((h, w, 3)).astype(np.float32)
    prev = np.zeros((h, w), np.uint8)
    prev[10:40, 10:50] = 1
    prev[45:60, 60:85] = 2
    scr = np.full((h, w), 255, np.uint8)
    scr[20:23, 15:45] = 1
    scr[50:52, 62:80] = 2
    scr[5:7, 70:88] = 0
    jc = JS(tree, 2)
    tc = S2MController(load_s2m_state_dict(str(path)), 2, device='cpu')
    ref = np.asarray(jc.interact(jnp.asarray(image), jnp.asarray(prev), scr))
    ours = tc.interact(torch.from_numpy(image), prev, scr).numpy()
    assert ours.shape == ref.shape == (2, h, w)
    assert np.abs(ours - ref).max() < 1e-3
    assert 0.01 < ours.mean() < 0.99


def test_controller_needs_cuda_unless_asked(s2m):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from xmem2_tpu_torch.interactive.s2m.controller import S2MController
    from xmem2_tpu_torch.interactive.s2m.network import load_s2m_state_dict
    sd = load_s2m_state_dict(str(s2m[0]))
    with pytest.raises(RuntimeError, match='CUDA'):
        S2MController(sd, 2)
    assert S2MController(sd, 2, device='cpu').device == torch.device('cpu')
