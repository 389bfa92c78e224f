"""The port's f-BRS (xmem2_tpu_torch/interactive/fbrs/) against the JAX
package's on the CPU, same weights, float32.

Weights: names and shapes from the port's own modules (narrow widths: stem
8, base 8, DeepLab ch 16; HRNet width 4, OCR width 8), filled by
tests/golden_utils.synth_state_dict and saved as one .pth that both packages
load (the JAX loader transposes to HWIO). The last head conv is tamed
(weight x 1e-3, bias -2) so the logits are O(1) and the masks non-trivial.
Images are 64x96 with a coloured ellipse.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.golden_utils import synth_state_dict

H, W = 64, 96


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def synth_pth(module, path, tame=None):
    """Seeded weights for `module`'s state-dict names, saved as a .pth."""
    ref = module.state_dict()
    names = [k for k in ref if not k.endswith('num_batches_tracked')]
    sd = synth_state_dict(names, [tuple(ref[k].shape) for k in names])
    for name, (scale, bias) in (tame or {}).items():
        sd[name + '.weight'] = sd[name + '.weight'] * np.float32(scale)
        sd[name + '.bias'][:] = bias
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return sd


def blob_image(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    blob = ((yy - 32) / 14) ** 2 + ((xx - 40) / 20) ** 2 < 1
    img = np.where(blob[..., None], np.array([1.5, -0.5, -1.0]),
                   np.array([-0.8, 0.6, 0.4])).astype(np.float32)
    return img + 0.1 * rng.standard_normal((H, W, 3)).astype(np.float32)


@pytest.fixture(scope='module')
def deeplab(tmp_path_factory):
    """(checkpoint path, JAX tree, port model on the CPU)."""
    from xmem2_tpu.interactive.fbrs.model import load_fbrs_params
    from xmem2_tpu_torch.interactive.fbrs.model import FBRSModel
    from xmem2_tpu_torch.interactive.fbrs.utils import (
        build_is_model, load_is_model)
    path = tmp_path_factory.mktemp('fbrs') / 'fbrs.pth'
    synth_pth(FBRSModel(stem=8, base=8, ch=16), path,
              {'head.layers.2': (1e-3, -2.0)})
    return path, load_fbrs_params(str(path)), \
        build_is_model(load_is_model(str(path)), 'cpu')


@pytest.fixture(scope='module')
def hrnet(tmp_path_factory):
    from xmem2_tpu.interactive.fbrs.model import load_fbrs_params
    from xmem2_tpu_torch.interactive.fbrs.hrnet import HRNetModel
    from xmem2_tpu_torch.interactive.fbrs.utils import (
        build_is_model, load_is_model)
    path = tmp_path_factory.mktemp('hrnet') / 'hrnet.pth'
    synth_pth(HRNetModel(width=4, ocr_width=8, small=True), path,
              {'feature_extractor.cls_head': (1e-2, 0.0)})
    return path, load_fbrs_params(str(path)), \
        build_is_model(load_is_model(str(path)), 'cpu')


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a), -1, 1)))


def scale_err(ours, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(ours) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


def coord_pair(points):
    """BFS dist maps from the port's native library, as (JAX NHWC, port
    NCHW) of one [1, 2, H, W] batch."""
    from xmem2_tpu_torch.interactive.clicks.dist_maps import (
        encode_dist, get_dist_maps_native)
    d = encode_dist(get_dist_maps_native(np.asarray(points, np.float32), H,
                                         W, 260.0))[None]
    return jnp.asarray(np.moveaxis(d, 1, -1)), torch.from_numpy(d)


# -------------------------------------------------------------------- model

def test_state_dict_round_trip(deeplab, hrnet):
    """The JAX trees (HWIO, `gap` nested) convert back to the very state
    dicts the port loads strictly."""
    from xmem2_tpu_torch.bridge.torch_params import tree_to_state_dict
    for path, tree, model in (deeplab, hrnet):
        sd = tree_to_state_dict(tree)
        ours = model.state_dict()
        assert set(sd) == set(ours)
        for k, v in sd.items():
            np.testing.assert_array_equal(v, ours[k].numpy(), err_msg=k)


def test_deeplab_forward(deeplab):
    """DistMapsModel forward, batch of 2 (the flip batch), ragged 72x88:
    logits within 1e-5 of their largest magnitude."""
    from xmem2_tpu.interactive.fbrs import model as M
    _, tree, model = deeplab
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 72, 88, 3)).astype(np.float32)
    coord = rng.random((2, 72, 88, 2)).astype(np.float32)
    ref = np.asarray(M.forward(tree, jnp.asarray(img), jnp.asarray(coord)))
    with torch.no_grad():
        ours = model(nchw(img), nchw(coord)).numpy()
    assert ours.shape == (2, 1, 72, 88)
    assert scale_err(ours[:, 0], ref[..., 0]) < 1e-5


def test_hrnet_forward(hrnet):
    """Small HRNet+OCR (2 blocks a branch) forward, 64x96: logits within
    1e-5 of their largest magnitude."""
    from xmem2_tpu.interactive.fbrs import hrnet as HR
    _, tree, model = hrnet
    assert model.feature_extractor.layer1[-1] is model.feature_extractor \
        .layer1[1]                                 # small: 2 bottlenecks
    img = blob_image()[None]
    jc, tc = coord_pair([[30, 40], [-1, -1]])
    ref = np.asarray(HR.forward(tree, jnp.asarray(img), jc, small=True))
    with torch.no_grad():
        ours = model(nchw(img), tc).numpy()
    assert scale_err(ours[:, 0], ref[..., 0]) < 1e-5


# ---------------------------------------------------- predictors and modes

MODES = {'f-BRS-A': 'after_c4', 'f-BRS-B': 'after_aspp',
         'f-BRS-C': 'after_deeplab'}


def _predictors(tree, model, brs_mode, **kw):
    from xmem2_tpu.interactive.fbrs.predictor import get_predictor as jget
    from xmem2_tpu_torch.interactive.fbrs.predictor import get_predictor
    return jget(tree, brs_mode=brs_mode, **kw), \
        get_predictor(model, brs_mode=brs_mode, **kw)


@pytest.mark.parametrize('brs_mode', list(MODES))
def test_insertion_modes(deeplab, brs_mode):
    """Each insertion mode: the head input within 1e-5 of its scale;
    _predict_with_opt's logits within 1e-4 of theirs at a random opt
    vector; _loss_and_grad's loss within 1e-5 relative and its gradient
    within 1e-4 of the largest entry."""
    _, tree, model = deeplab
    jp, tp = _predictors(tree, model, brs_mode, with_flip=False)
    assert tp.insertion_mode == jp.insertion_mode == MODES[brs_mode]
    assert tp.num_channels == jp.num_channels
    img = blob_image()[None]
    jc, tc = coord_pair([[32, 40], [20, 80], [50, 10], [-1, -1]])
    jin = jp._get_head_input(jnp.asarray(img), jc)
    tin = tp._get_head_input(nchw(img), tc)
    for key in jin:
        assert scale_err(tin[key].numpy(), np.moveaxis(
            np.asarray(jin[key]), -1, 1)) < 1e-5, key

    rng = np.random.default_rng(1)
    x = (0.1 * rng.standard_normal(2 * tp.num_channels)).astype(np.float32)
    jlog, jreg = jp._predict_with_opt(jnp.asarray(x), jin, (H, W))
    with torch.no_grad():
        tlog, treg = tp._predict_with_opt(torch.from_numpy(x), tin, (H, W))
    assert scale_err(tlog.numpy()[:, 0], np.asarray(jlog)[..., 0]) < 1e-4
    np.testing.assert_allclose(float(treg), float(jreg), rtol=1e-5)

    from xmem2_tpu_torch.interactive.clicks.dist_maps import Click
    clicks = [[Click(True, (32, 40)), Click(True, (20, 80)),
               Click(False, (50, 10))]]
    jpos, jneg = jp._clicks_maps(clicks, (H, W))
    tpos, tneg = tp._clicks_maps(clicks, (H, W))
    np.testing.assert_array_equal(tpos.numpy()[:, 0], np.asarray(jpos)[..., 0])
    (jl, _), jg = jp._loss_and_grad(jnp.asarray(x), jin, jpos, jneg, (H, W))
    (tl, _), tg = tp._loss_and_grad(x, tin, tpos, tneg, (H, W))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert scale_err(tg.numpy(), jg) < 1e-4


@pytest.mark.parametrize('mode', ['A', 'C'])
def test_hrnet_insertion_modes(hrnet, mode):
    """HRNet f-BRS 'A' (stitched features) and 'C' (OCR output): head input
    and logits within 1e-4 of their scale, loss 1e-5 relative, gradient
    1e-4 of its largest entry."""
    from xmem2_tpu_torch.interactive.clicks.dist_maps import Click
    _, tree, model = hrnet
    brs_mode = 'f-BRS-A' if mode == 'A' else 'f-BRS-C'
    jp, tp = _predictors(tree, model, brs_mode, with_flip=False)
    assert tp.insertion_mode == jp.insertion_mode == mode
    assert tp.num_channels == jp.num_channels
    img = blob_image()[None]
    jc, tc = coord_pair([[32, 40], [50, 10]])
    jin = jp._get_head_input(jnp.asarray(img), jc)
    tin = tp._get_head_input(nchw(img), tc)
    assert scale_err(tin['feats'].numpy(), np.moveaxis(
        np.asarray(jin['feats']), -1, 1)) < 1e-4
    x = (0.1 * np.random.default_rng(2).standard_normal(
        2 * tp.num_channels)).astype(np.float32)
    clicks = [[Click(True, (32, 40)), Click(False, (50, 10))]]
    jpos, jneg = jp._clicks_maps(clicks, (H, W))
    tpos, tneg = tp._clicks_maps(clicks, (H, W))
    (jl, jaux), jg = jp._loss_and_grad(jnp.asarray(x), jin, jpos, jneg,
                                       (H, W))
    (tl, taux), tg = tp._loss_and_grad(x, tin, tpos, tneg, (H, W))
    assert scale_err(taux[0].numpy()[:, 0], np.asarray(jaux[0])[..., 0]) \
        < 1e-4
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert scale_err(tg.numpy(), jg) < 1e-4


ALL_MODES = ['NoBRS', 'f-BRS-A', 'f-BRS-B', 'f-BRS-C', 'RGB-BRS',
             'DistMap-BRS']


def test_get_predictor_dispatch(deeplab, hrnet):
    """All six modes pick the JAX package's class and settings, for both
    backbones."""
    for _, tree, model in (deeplab, hrnet):
        for mode in ALL_MODES:
            jp, tp = _predictors(tree, model, mode)
            assert type(tp).__name__ == type(jp).__name__, mode
            for attr in ('insertion_mode', 'optimize_target',
                         'net_clicks_limit', 'with_flip', 'num_channels'):
                assert getattr(tp, attr, None) == getattr(jp, attr, None), \
                    (mode, attr)
            assert [type(t).__name__ for t in tp.transforms] == \
                [type(t).__name__ for t in jp.transforms]


@pytest.mark.parametrize('brs_mode', ALL_MODES)
def test_modes_predict_like_jax(deeplab, brs_mode):
    """Two clicks through each mode's whole prediction (transforms, BRS):
    probabilities within 1e-3, masks equal on at least 99% of pixels (the
    L-BFGS trajectory may branch on an early exit)."""
    from xmem2_tpu.interactive.clicks.dist_maps import Clicker as JClicker
    from xmem2_tpu.interactive.clicks.dist_maps import Click as JClick
    from xmem2_tpu_torch.interactive.clicks.dist_maps import Click, Clicker
    _, tree, model = deeplab
    jp, tp = _predictors(tree, model, brs_mode,
                         zoom_in_params={'target_size': 96})
    img = blob_image()
    jp.set_input_image(jnp.asarray(img))
    tp.set_input_image(torch.from_numpy(img))
    jc, tc = JClicker(), Clicker()
    for pos, rc in ((True, (32, 40)), (False, (10, 85))):
        jc.add_click(JClick(pos, rc))
        tc.add_click(Click(pos, rc))
        ref = np.asarray(jp.get_prediction(jc))[0, ..., 0]
        ours = tp.get_prediction(tc).numpy()[0, 0]
    assert np.mean((ref > 0.5) != (ours > 0.5)) <= 0.01
    if brs_mode == 'NoBRS':
        assert np.abs(ours - ref).max() < 1e-3


# --------------------------------------------------------------- transforms

def test_transforms_forward_inverse_and_state():
    """ZoomIn (after a first prediction), LimitLongestSide, the flip and the
    sigmoid: images, clicks and inverse maps equal the JAX package's within
    1e-5; get_state/set_state restore a zoom."""
    from xmem2_tpu.interactive.clicks.dist_maps import Click as JClick
    from xmem2_tpu.interactive.fbrs import transforms as JT
    from xmem2_tpu_torch.interactive.clicks.dist_maps import Click
    from xmem2_tpu_torch.interactive.fbrs import transforms as TT

    rng = np.random.default_rng(3)
    img = rng.standard_normal((1, 120, 200, 3)).astype(np.float32)
    prob = np.zeros((1, 120, 200, 1), np.float32)
    prob[0, 40:70, 60:110] = 0.9
    jclicks = [[JClick(True, (50, 80)), JClick(False, (100, 20)),
                JClick(True, (60, 100))]]
    tclicks = [[Click(c.is_positive, c.coords) for c in jclicks[0]]]

    jz = JT.ZoomIn(target_size=96, min_crop_size=40)
    tz = TT.ZoomIn(target_size=96, min_crop_size=40)
    for z, p in ((jz, jnp.asarray(prob)), (tz, nchw(prob))):
        z.inv_transform(p)              # the previous prediction
    ji, jcl = jz.transform(jnp.asarray(img), jclicks)
    ti, tcl = tz.transform(nchw(img), tclicks)
    assert tz._object_roi == jz._object_roi and tz.image_changed
    assert scale_err(ti.numpy(), np.moveaxis(np.asarray(ji), -1, 1)) < 1e-5
    assert [c.coords for c in tcl[0]] == pytest.approx(
        [c.coords for c in jcl[0]])
    state = tz.get_state()
    small = rng.random((1, ti.shape[2], ti.shape[3], 1)).astype(np.float32)
    jinv = np.asarray(jz.inv_transform(jnp.asarray(small)))
    tinv = tz.inv_transform(nchw(small)).numpy()
    assert scale_err(tinv[:, 0], jinv[..., 0]) < 1e-5
    tz.set_state(state)
    assert tz._object_roi == jz._object_roi
    assert torch.equal(tz._prev_probs, nchw(prob))

    jl, tl = JT.LimitLongestSide(max_size=100), TT.LimitLongestSide(100)
    ji, jcl = jl.transform(jnp.asarray(img), jclicks)
    ti, tcl = tl.transform(nchw(img), tclicks)
    assert ti.shape[-2:] == ji.shape[1:3] == (60, 100)
    assert scale_err(ti.numpy(), np.moveaxis(np.asarray(ji), -1, 1)) < 1e-5
    assert [c.coords for c in tcl[0]] == pytest.approx(
        [c.coords for c in jcl[0]])

    jf, tf = JT.AddHorizontalFlip(), TT.AddHorizontalFlip()
    ji, jcl = jf.transform(jnp.asarray(img), jclicks)
    ti, tcl = tf.transform(nchw(img), tclicks)
    np.testing.assert_array_equal(ti.numpy(), np.moveaxis(np.asarray(ji),
                                                          -1, 1))
    assert [c.coords for cl in tcl for c in cl] == \
        [c.coords for cl in jcl for c in cl]
    two = rng.random((2, 120, 200, 1)).astype(np.float32)
    np.testing.assert_allclose(tf.inv_transform(nchw(two)).numpy()[:, 0],
                               np.asarray(jf.inv_transform(
                                   jnp.asarray(two)))[..., 0], atol=1e-6)
    np.testing.assert_allclose(
        TT.SigmoidForPred().inv_transform(nchw(two)).numpy()[:, 0],
        np.asarray(JT.SigmoidForPred().inv_transform(
            jnp.asarray(two)))[..., 0], atol=1e-6)


# -------------------------------------------------------------- controller

def test_fbrs_controller_click_sequence_with_undo(deeplab):
    """FBRSController (f-BRS-B, flip, zoom-in, L-BFGS) against the JAX one
    on the same image: two positive clicks and a negative one, then undo.
    Each click's mask equal on at least 99% of pixels (the L-BFGS
    trajectory may branch on an early exit; the count is reported), the
    third click runs L-BFGS for more than one evaluation, and undo restores
    the second click's mask exactly. Zoom-in targets 96 pixels here (480 in
    the GUI) so the crop stays small."""
    from xmem2_tpu.interactive.fbrs.controller import FBRSController as JC
    from xmem2_tpu_torch.interactive.fbrs.controller import FBRSController
    path, _, _ = deeplab
    jc = JC(str(path))
    tc = FBRSController(str(path), device='cpu')
    for c in (jc, tc):
        c.controller.predictor_params['zoom_in_params']['target_size'] = 96
    image = blob_image()
    masks, differ = [], []
    for x, y, pos in ((40, 32, True), (70, 20, True), (45, 40, False)):
        ref = np.asarray(jc.interact(jnp.asarray(image), x, y, pos))
        ours = tc.interact(torch.from_numpy(image), x, y, pos).numpy()
        differ.append(int((ref != ours).sum()))
        masks.append(ours)
    assert tc.controller.predictor.zoom_in._object_roi == \
        jc.controller.predictor.zoom_in._object_roi is not None
    assert tc.last_evaluations > 1
    assert max(differ) <= 0.01 * H * W, differ
    ref = np.asarray(jc.undo())
    ours = tc.undo().numpy()
    np.testing.assert_array_equal(ours, masks[1])
    assert np.mean(ref != ours) <= 0.01
    assert len(tc.controller.states) == len(jc.controller.states) == 2


def test_load_is_model_rejects_resnet34(tmp_path):
    from xmem2_tpu_torch.interactive.fbrs.utils import (
        detect_backbone, load_is_model)
    path = tmp_path / 'r34.pth'
    torch.save({'feature_extractor.backbone.conv1.weight':
                torch.zeros(64, 3, 7, 7)}, path)
    assert detect_backbone(['feature_extractor.backbone.conv1.weight']) \
        == 'resnet34'
    with pytest.raises(NotImplementedError, match='resnet34'):
        load_is_model(str(path))
    with pytest.raises(ValueError):
        detect_backbone(['something.else'])
