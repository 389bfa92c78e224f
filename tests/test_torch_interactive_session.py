"""The port's SessionController against the JAX package's on one workspace
on the CPU, float32: the same XMem weights (tests/test_torch_run_on_video.
synth_params), narrow S2M and f-BRS weights (as in the S2M and f-BRS tests),
the same 8 frames of 64x96 with two ellipses.

Propagated masks are compared pixel by pixel: these random weights give
the decoder logits of magnitude ~1e3, so a pixel whose logit sits near zero
flips between the packages under float32 rounding of the readout. At most
0.5% of a frame's pixels may differ (measured: up to 8 of 6,144, 0.13%).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_fbrs import synth_pth
from tests.test_torch_run_on_video import synth_params

H, W, N = 64, 96, 8
CFG = {'hidden_dim': 64, 'top_k': 30, 'mem_every': 2,
       'deep_update_every': -1, 'enable_long_term': True,
       'enable_long_term_count_usage': True, 'max_mid_term_frames': 4,
       'min_mid_term_frames': 2, 'num_prototypes': 16,
       'max_long_term_elements': 1000, 'size': -1}
PORT_CFG = dict(CFG, compute_dtype='float32', value_store_dtype='float32')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ellipses(t):
    yy, xx = np.mgrid[0:H, 0:W]
    label = np.zeros((H, W), np.uint8)
    label[((yy - 30) / 14) ** 2 + ((xx - 20 - 2 * t) / 18) ** 2 < 1] = 1
    label[((yy - 20) / 10) ** 2 + ((xx - 70 + t) / 12) ** 2 < 1] = 2
    return label


def palette_png(label, path):
    img = Image.fromarray(label, mode='P')
    img.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0] + [0] * 759)
    img.save(path)


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    """Frames, XMem networks of both packages, S2M and f-BRS checkpoints."""
    from xmem2_tpu.bridge.torch_params import convert_state_dict
    from xmem2_tpu.inference.net import XMemNet as JNet
    from xmem2_tpu_torch.bridge.torch_params import build_model
    from xmem2_tpu_torch.bridge.torch_params import \
        convert_state_dict as tconvert
    from xmem2_tpu_torch.inference.net import XMemNet
    from xmem2_tpu_torch.interactive.fbrs.model import FBRSModel
    from xmem2_tpu_torch.interactive.s2m.network import S2MNet

    root = tmp_path_factory.mktemp('session')
    rng = np.random.default_rng(0)
    frames = root / 'frames'
    frames.mkdir()
    bg = rng.integers(0, 255, (H // 8, W // 8, 3)).astype(np.uint8)
    bg = np.asarray(Image.fromarray(bg).resize((W, H), Image.BILINEAR))
    for t in range(N):
        f = bg.copy()
        label = ellipses(t)
        f[label == 1] = (220, 60, 40)
        f[label == 2] = (40, 200, 90)
        f = np.clip(f.astype(int) + rng.integers(-12, 12, f.shape), 0,
                    255).astype(np.uint8)
        Image.fromarray(f).save(frames / f'{t:05d}.jpg', quality=95)
    palette_png(ellipses(0), root / 'mask0.png')
    sd = synth_params()
    tsd, dims = tconvert(sd)
    s2m, fbrs = root / 's2m.pth', root / 'fbrs.pth'
    synth_pth(S2MNet(stem=8, base=8, ch=16, low_ch=8), s2m,
              {'classifier.classifier.3': (1e-2, 0.0)})
    synth_pth(FBRSModel(stem=8, base=8, ch=16), fbrs,
              {'head.layers.2': (1e-3, -2.0)})
    return {'root': root, 'frames': frames,
            'jnet': JNet(convert_state_dict(sd)),
            'tnet': XMemNet(build_model(tsd, dims, 'cpu'),
                            compute_dtype='float32', device='cpu'),
            's2m': s2m, 'fbrs': fbrs}


def make_sessions(assets, tmp_path, tools=True):
    """(JAX SessionController, port SessionController, logs) on copies of
    one workspace of 2 objects."""
    from xmem2_tpu.inference.core import InferenceCore as JCore
    from xmem2_tpu.interactive.fbrs.controller import FBRSController as JF
    from xmem2_tpu.interactive.resource_manager import ResourceManager as JRM
    from xmem2_tpu.interactive.s2m import S2MController as JS2M
    from xmem2_tpu.interactive.s2m import load_s2m_params
    from xmem2_tpu.interactive.session import SessionController as JS
    from xmem2_tpu_torch.inference.core import InferenceCore
    from xmem2_tpu_torch.interactive.fbrs.controller import FBRSController
    from xmem2_tpu_torch.interactive.resource_manager import ResourceManager
    from xmem2_tpu_torch.interactive.s2m import (
        S2MController, load_s2m_state_dict)
    from xmem2_tpu_torch.interactive.session import SessionController

    def rm_cfg(tag):
        return {'images': str(assets['frames']), 'video': None,
                'workspace': str(tmp_path / f'ws_{tag}'), 'size': -1,
                'num_objects': 2, 'buffer_size': 10}

    jtools = tools and (JS2M(load_s2m_params(str(assets['s2m'])), 2),
                        JF(str(assets['fbrs'])))
    ttools = tools and (S2MController(load_s2m_state_dict(
        str(assets['s2m'])), 2, device='cpu'),
        FBRSController(str(assets['fbrs']), device='cpu'))
    logs = {'jax': [], 'torch': []}
    j = JS(JCore(assets['jnet'], config=dict(CFG)), JRM(rm_cfg('jax')),
           *(jtools or (None, None)), CFG, log=logs['jax'].append)
    t = SessionController(InferenceCore(assets['tnet'], dict(PORT_CFG),
                                        device='cpu'),
                          ResourceManager(rm_cfg('torch')),
                          *(ttools or (None, None)), PORT_CFG,
                          log=logs['torch'].append)
    return j, t, logs


def both(pair, fn):
    return fn(pair[0]), fn(pair[1])


def capture_probs(ctl, to_numpy):
    """Records the probabilities _store_step receives, by frame."""
    seen = {}
    store = ctl._store_step

    def hooked(ti, prob, *a, **k):
        seen[ti] = to_numpy(prob)
        return store(ti, prob, *a, **k)

    ctl._store_step = hooked
    return seen


def assert_masks_close(jprob, tprob):
    """The argmax masks of two probability maps differ on at most 0.5% of
    the pixels."""
    differ = np.mean(jprob.argmax(0) != tprob.argmax(0))
    assert differ <= 5e-3, differ


def test_scribble_brush_and_click_masks(assets, tmp_path):
    """Scribbles for both objects (S2M), a brush stroke committed over them,
    then two f-BRS clicks on object 1: each saved mask as in the JAX
    session (scribble and brush masks equal on >= 99.9% of pixels, the
    click mask on >= 99%)."""
    pair = make_sessions(assets, tmp_path)[:2]
    for ctl in pair:
        ctl.current_object = 1
        for x, y in ((12, 30), (20, 31), (28, 30)):
            ctl.push_point(x, y, False, 'scribble')
        ctl.end_path()
        ctl.current_object = 2
        for x, y in ((64, 20), (72, 21)):
            ctl.push_point(x, y, False, 'scribble')
        ctl.push_point(40, 55, True, 'scribble')      # a negative stroke
        ctl.push_point(50, 56, True, 'scribble')
        ctl.end_path()
        ctl.commit()
    jm, tm = both(pair, lambda c: c.res_man.get_mask(0))
    assert np.mean(jm != tm) <= 1e-3 and tm.max() == 2
    for ctl in pair:
        ctl.set_brush_size(5)
        ctl.current_object = 1
        for x, y in ((30, 40), (45, 45)):
            ctl.push_point(x, y, False, 'free')
        ctl.commit()
    jm, tm = both(pair, lambda c: c.res_man.get_mask(0))
    assert np.mean(jm != tm) <= 1e-3
    for ctl in pair:
        ctl.set_cursor(1)
        ctl.current_object = 1
        ctl.fbrs_controller.controller.predictor_params['zoom_in_params'][
            'target_size'] = 96
        ctl.push_point(22.0, 30.0, False, 'click')
        ctl.push_point(80.0, 50.0, True, 'click')
        ctl.commit()
    jm, tm = both(pair, lambda c: c.res_man.get_mask(1))
    assert np.mean(jm != tm) <= 1e-2 and (tm == 1).any()


def test_reference_propagation_and_key_cache(assets, tmp_path):
    """A reference imported on frame 0, propagated forward over 7 frames:
    masks as in the JAX session (<= 0.5% of pixels), the key cache
    channels-last and within 1e-4 of the JAX keys' scale, the small masks
    within 1e-3 where the masks agree."""
    jctl, tctl, _ = make_sessions(assets, tmp_path, tools=False)
    jp = capture_probs(jctl, np.asarray)
    tp = capture_probs(tctl, lambda p: p.numpy())
    for ctl in (jctl, tctl):
        assert ctl.import_mask(str(assets['root'] / 'mask0.png'))
        assert ctl.res_man.references == {0}
        assert ctl.propagate('forward') == N - 1
        assert ctl.res_man.all_masks_present()
    for ti in range(N):
        assert_masks_close(jp[ti], tp[ti])
    jk, tk = jctl.res_man.keys, tctl.res_man.keys
    assert tk.shape == jk.shape and tk.device == torch.device('cpu')
    scale = np.abs(jk).max()
    assert np.abs(tk.numpy() - jk).max() <= 1e-4 * scale
    assert np.abs(tctl.res_man.shrinkages.numpy()
                  - jctl.res_man.shrinkages).max() <= \
        1e-4 * np.abs(jctl.res_man.shrinkages).max()
    assert tctl.res_man.small_masks.shape == jctl.res_man.small_masks.shape


def test_replay_remove_and_full_propagation(assets, tmp_path):
    """References replay into a new processor as in the JAX package;
    remove_reference empties permanent memory; full_propagate starts at the
    first reference."""
    from xmem2_tpu.inference.core import InferenceCore as JCore
    from xmem2_tpu.interactive.session import SessionController as JS
    from xmem2_tpu_torch.inference.core import InferenceCore
    from xmem2_tpu_torch.interactive.session import SessionController
    jctl, tctl, _ = make_sessions(assets, tmp_path, tools=False)
    for ctl in (jctl, tctl):
        ctl.set_cursor(2)
        assert ctl.import_mask(str(assets['root'] / 'mask0.png'))
    j2 = JS(JCore(assets['jnet'], config=dict(CFG)), jctl.res_man, None,
            None, CFG)
    t2 = SessionController(InferenceCore(assets['tnet'], dict(PORT_CFG),
                                         device='cpu'), tctl.res_man,
                           None, None, PORT_CFG)
    assert t2.replay_references() == j2.replay_references() == [2]
    assert t2.processor.permanent_memory_frames == \
        j2.processor.permanent_memory_frames == [2]
    assert t2.memory_stats() == j2.memory_stats()
    for ctl in (jctl, tctl):
        ctl.set_cursor(5)
        assert ctl.full_propagate() == N - 3
        assert ctl.cursur == N - 1
    for ti in range(2, N):
        jm, tm = jctl.res_man.get_mask(ti), tctl.res_man.get_mask(ti)
        assert np.mean(jm != tm) <= 5e-3
    for ctl in (jctl, tctl):
        ctl.set_cursor(2)
        assert ctl.remove_reference()
        assert ctl.processor.permanent_memory_frames == []


def test_candidates(assets, tmp_path):
    """After a full propagation, compute_candidates picks what the JAX
    session picks; on the cached keys with no mask-presence floor, the
    selector ranks real candidates, again as in the JAX package."""
    from xmem2_tpu.inference.frame_selection.frame_selection import \
        select_next_candidates as jselect
    from xmem2_tpu_torch.inference.frame_selection.frame_selection import \
        select_next_candidates
    jctl, tctl, _ = make_sessions(assets, tmp_path, tools=False)
    assert tctl.compute_candidates(k=2) is None
    for ctl in (jctl, tctl):
        assert ctl.import_mask(str(assets['root'] / 'mask0.png'))
        ctl.full_propagate()
    assert tctl.compute_candidates(k=3) == jctl.compute_candidates(k=3)
    jrm, trm = jctl.res_man, tctl.res_man
    ours = select_next_candidates(
        trm.keys, trm.shrinkages, trm.selections, list(trm.small_masks), 3,
        previously_chosen_candidates=[0], min_mask_presence_percent=0,
        device='cpu')
    ref = jselect(jrm.keys, jrm.shrinkages, jrm.selections,
                  list(jrm.small_masks), 3, previously_chosen_candidates=[0],
                  min_mask_presence_percent=0)
    assert [int(c) for c in ours] == [int(c) for c in ref]
    assert len(set(ours)) == 3 and 0 not in ours


def test_bulk_import_and_config(assets, tmp_path):
    """import_all_masks (bulk: no references, cursor back to 0), the small
    batch path (references saved), update_config and memory_stats as in
    the JAX session; the port reports no device entry on the CPU."""
    d = tmp_path / 'masks'
    d.mkdir()
    for fi in range(N):
        palette_png(ellipses(fi), d / f'{fi:05d}.png')
    jctl, tctl, _ = make_sessions(assets, tmp_path, tools=False)
    progress = {'jax': [], 'torch': []}
    jr = jctl.import_all_masks(str(d), progress['jax'].append,
                               bulk_threshold=4)
    tr = tctl.import_all_masks(str(d), progress['torch'].append,
                               bulk_threshold=4)
    assert tr == jr == {'imported': N, 'errors': []}
    assert progress['torch'] == progress['jax'] == list(range(1, N + 1))
    assert tctl.cursur == jctl.cursur == 0
    assert tctl.res_man.references == jctl.res_man.references == set()
    for fi in range(N):
        np.testing.assert_array_equal(tctl.res_man.get_mask(fi),
                                      jctl.res_man.get_mask(fi))
    small = tmp_path / 'small'
    small.mkdir()
    for fi in (1, 3):
        palette_png(ellipses(fi), small / f'{fi:05d}.png')
    assert tctl.import_all_masks(str(small)) == \
        jctl.import_all_masks(str(small))
    assert tctl.res_man.references == jctl.res_man.references == {1, 3}
    assert tctl.memory_stats() == jctl.memory_stats()
    assert 'device_bytes_in_use' not in tctl.memory_stats()
    for ctl in (jctl, tctl):
        ctl.update_config({'top_k': 7, 'mem_every': 9})
    assert tctl.processor.memory.top_k == jctl.processor.memory.top_k == 7
    assert tctl.processor.mem_every == jctl.processor.mem_every == 9
