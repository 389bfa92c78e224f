"""The port's XMem network against xmem2_tpu.models.network, with the same
weights carried across, and against the torch-captured goldens
(tests/golden/model_golden.npz) at the tolerances of
tests/test_model_golden.py. Also the weight bridge: JAX parameter trees,
JAX .npz checkpoints and reference .pth state dicts.

Layouts: the JAX package is NHWC with object groups [B, N, H, W, C]; the
port is NCHW with groups [B, N, C, H, W].
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.conftest import load_golden
from tests.golden_utils import synth_state_dict
from xmem2_tpu.bridge import torch_params as JB
from xmem2_tpu.models import network as XN
from xmem2_tpu_torch.bridge import torch_params as TB

# float32 on both sides; activations reach O(1e3) with the synthetic
# weights and the two libraries sum convolutions in other orders, so errors
# are held relative to each output's magnitude: 1e-4 of max |ref| (seen:
# 3e-5 on the values; 6e-5 on the sigmoid selection, whose inputs are O(1e3))
REL = 1e-4


def nhwc_to_nchw(x):
    return np.moveaxis(np.asarray(x), -1, -3)


def close(got, ref, name, rel=REL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, name
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()) + 1e-6, \
        f'{name}: max abs err {err} vs scale {np.abs(ref).max()}'


@pytest.fixture(scope='module')
def setup():
    g = load_golden('model_golden')
    names = [str(n) for n in g['sdmeta/names']]
    shapes = [tuple(s[:nd]) for s, nd in
              zip(g['sdmeta/shapes'], g['sdmeta/ndims'])]
    sd = synth_state_dict(names, shapes)
    jparams = JB.convert_state_dict(sd)
    tsd, dims = TB.params_from_jax(jparams)
    model = TB.build_model(tsd, dims, device='cpu')
    image = g['in/image']
    jkey = XN.encode_key(jparams, jnp.asarray(np.moveaxis(image, 1, -1)))
    with torch.no_grad():
        tkey = model.encode_key(torch.from_numpy(image))
    return dict(g=g, sd=sd, jparams=jparams, model=model, jkey=jkey,
                tkey=tkey, dims=dims)


def test_bridge_round_trip(setup):
    """convert_state_dict (JAX) -> params_from_jax (port) gives back the
    original reference state dict exactly."""
    tsd, dims = TB.params_from_jax(setup['jparams'])
    assert dims == (64, 512, 64)
    assert set(tsd) == set(setup['sd'])
    for k, v in setup['sd'].items():
        np.testing.assert_array_equal(tsd[k], v, err_msg=k)


def test_bridge_npz_and_pth(setup, tmp_path):
    """The JAX .npz checkpoint and a single-object reference .pth (4-channel
    value conv1, with num_batches_tracked) load into the port."""
    npz = tmp_path / 'ckpt.npz'
    JB.save_params(setup['jparams'], str(npz))
    sd_npz, dims = TB.load_state_dict_file(str(npz))
    assert dims == setup['dims']
    for k, v in setup['sd'].items():
        np.testing.assert_array_equal(sd_npz[k], v, err_msg=k)

    pth = {k: torch.from_numpy(v) for k, v in setup['sd'].items()}
    pth['value_encoder.conv1.weight'] = pth['value_encoder.conv1.weight'][:, :4]
    pth['key_encoder.bn1.num_batches_tracked'] = torch.tensor(7)
    torch.save(pth, tmp_path / 'ckpt.pth')
    model = TB.load_model(str(tmp_path / 'ckpt.pth'), device='cpu')
    w = model.value_encoder.conv1.weight
    assert w.shape == (64, 5, 7, 7)
    assert not w[:, 4].any()                   # zero-padded 5th channel
    torch.testing.assert_close(w[:, :4], pth['value_encoder.conv1.weight'])


def test_encode_key(setup):
    names = ('key', 'shrinkage', 'selection', 'f16', 'f8', 'f4')
    for name, got, ref in zip(names, setup['tkey'], setup['jkey']):
        close(got, nhwc_to_nchw(ref), name)


def test_encode_key_golden(setup):
    g = setup['g']
    for name, got in zip(('key', 'shrinkage', 'selection', 'f16', 'f8', 'f4'),
                         setup['tkey']):
        np.testing.assert_allclose(got.numpy(), g[f'ek/{name}'], rtol=1e-3,
                                   atol=1e-3, err_msg=name)


@pytest.mark.parametrize('n_obj,deep', [(2, True), (2, False), (1, True)])
def test_encode_value(setup, n_obj, deep):
    g = setup['g']
    f16_t = setup['tkey'][3]
    f16_j = setup['jkey'][3]
    image = g['in/image']
    masks = g['in/masks'][:, :n_obj]
    hidden = g['in/hidden'][:, :n_obj]                   # [B, N, C, h, w]
    jv, jh = XN.encode_value(setup['jparams'],
                             jnp.asarray(np.moveaxis(image, 1, -1)), f16_j,
                             jnp.asarray(np.moveaxis(hidden, 2, -1)),
                             jnp.asarray(masks), is_deep_update=deep)
    with torch.no_grad():
        tv, th = setup['model'].encode_value(
            torch.from_numpy(image), f16_t, torch.from_numpy(hidden),
            torch.from_numpy(masks), is_deep_update=deep)
    close(tv, np.moveaxis(np.asarray(jv), -1, 2), 'value')
    # the GRU's tanh inputs are O(100): the hidden state takes the decoder's
    # 1e-3 of scale (see test_segment)
    close(th, np.moveaxis(np.asarray(jh), -1, 2), 'hidden', rel=1e-3)
    if n_obj == 2:
        key = 'ev/g16' if deep else 'ev/g16_nodeep'
        np.testing.assert_allclose(tv.numpy(), g[key], rtol=1e-3, atol=5e-3)
        if deep:
            np.testing.assert_allclose(th.numpy(), g['ev/hidden'], rtol=1e-3,
                                       atol=1e-3)


@pytest.mark.parametrize('h_out,strip_bg', [(True, False), (False, True)])
def test_segment(setup, h_out, strip_bg):
    g = setup['g']
    readout, hidden = g['in/readout'], g['in/hidden']
    jh, jl, jp = XN.segment(setup['jparams'], setup['jkey'][3:],
                            jnp.asarray(np.moveaxis(readout, 2, -1)),
                            jnp.asarray(np.moveaxis(hidden, 2, -1)),
                            h_out=h_out, strip_bg=strip_bg)
    with torch.no_grad():
        th, tl, tp = setup['model'].segment(
            setup['tkey'][3:], torch.from_numpy(readout),
            torch.from_numpy(hidden), h_out=h_out, strip_bg=strip_bg)
    # the decoder's inputs f16/f8/f4 already differ by ~1e-5 relative; the
    # 1600-channel fuser and the GRU (tanh inputs O(100)) amplify that to
    # ~4e-4 of each output's scale (seen): 1e-3 of max |ref|
    close(tl, jl, 'logits', rel=1e-3)
    close(tp, jp, 'prob', rel=1e-3)
    if h_out:
        close(th, np.moveaxis(np.asarray(jh), -1, 2), 'hidden', rel=1e-3)
        # golden tolerances of tests/test_model_golden.py
        np.testing.assert_allclose(th.numpy(), g['seg/hidden'], rtol=1e-3,
                                   atol=1e-2)
        np.testing.assert_allclose(tl.numpy(), g['seg/logits'], rtol=1e-3,
                                   atol=5e-3)
        np.testing.assert_allclose(tp.numpy(), g['seg/prob'], rtol=1e-3,
                                   atol=1e-3)
    else:
        assert th is None and jh is None


def test_functional_resize_matches_jax():
    """resize_bilinear (integer-factor and general sizes), resize_nearest
    and interpolate_area_down against xmem2_tpu.nn.functional."""
    from xmem2_tpu.nn import functional as JF
    from xmem2_tpu_torch.nn import functional as TF
    x = np.random.default_rng(0).standard_normal((2, 3, 12, 20)).astype(
        np.float32)
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    xt = torch.from_numpy(x)
    for hw in ((24, 40), (48, 80), (17, 33), (7, 9)):
        np.testing.assert_allclose(
            TF.resize_bilinear(xt, hw).numpy(),
            nhwc_to_nchw(JF.resize_bilinear(xj, hw)), rtol=1e-5, atol=1e-5,
            err_msg=str(hw))
        np.testing.assert_array_equal(TF.resize_nearest(xt, hw).numpy(),
                                      nhwc_to_nchw(JF.resize_nearest(xj, hw)))
    for r in (0.5, 0.25):
        np.testing.assert_allclose(
            TF.interpolate_area_down(xt, r).numpy(),
            nhwc_to_nchw(JF.interpolate_area_down(xj, r)), rtol=1e-6,
            atol=1e-6)
