"""The port's main path as a whole: xmem2_tpu_torch run_on_video on the CPU
against xmem2_tpu run_on_video, same synthetic video and weights, f32.

The video: 16 frames of 64x96, object 1 annotated on frame 0 and objects 1+2
on frame 7 (a second object group), with memory settings small enough that
working memory consolidates into long-term memory twice and long-term memory
evicts once. The JAX side runs its per-frame split path (no chunking, no
fused frame program) to keep its compile time short; the port runs its
default chunked path. Both are the same computation.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from tests.conftest import load_golden
from tests.golden_utils import synth_state_dict

H, W, N_FRAMES = 64, 96, 16
ANNOTATED = (0, 7)
CONFIG = {'size': -1, 'top_k': 30, 'mem_every': 2, 'max_mid_term_frames': 4,
          'min_mid_term_frames': 2, 'num_prototypes': 16,
          'max_long_term_elements': 24, 'compute_dtype': 'float32',
          'value_store_dtype': 'float32'}


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """torch on one thread while this module runs: the suite runs files in
    parallel worker processes, and torch's intra-op threads in each spin
    against the others' (several times the CPU time on a shared machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def synth_params():
    """Golden-conditioned synthetic weights at the published widths, with
    the key/shrinkage projections tamed as tests/test_e2e_parity.py:46-47
    does (keeps similarities in a realistic range)."""
    meta = load_golden('model_golden')
    names = [str(n) for n in meta['sdmeta/names']]
    shapes = [tuple(s[:nd]) for s, nd in
              zip(meta['sdmeta/shapes'], meta['sdmeta/ndims'])]
    sd = synth_state_dict(names, shapes)
    sd['key_proj.key_proj.weight'] = sd['key_proj.key_proj.weight'] * 0.001
    sd['key_proj.d_proj.weight'] = sd['key_proj.d_proj.weight'] * 0.01
    return sd


def write_video(root):
    """Textured frames with two moving ellipses; palette masks on the
    annotated frames."""
    rng = np.random.default_rng(0)
    imgs, anns = root / 'imgs', root / 'anns'
    imgs.mkdir()
    anns.mkdir()
    yy, xx = np.mgrid[0:H, 0:W]
    bg = rng.integers(0, 255, (H // 8, W // 8, 3)).astype(np.uint8)
    bg = np.asarray(Image.fromarray(bg).resize((W, H), Image.BILINEAR))
    palette = [0, 0, 0, 128, 0, 0, 0, 128, 0] + [0] * (256 * 3 - 9)
    for t in range(N_FRAMES):
        label = np.zeros((H, W), np.uint8)
        label[((yy - 30) / 14) ** 2 + ((xx - 20 - 2 * t) / 18) ** 2 < 1] = 1
        if t >= ANNOTATED[1]:
            label[((yy - 20) / 10) ** 2 + ((xx - 70 + t) / 12) ** 2 < 1] = 2
        frame = bg.copy()
        frame[label == 1] = (220, 60, 40)
        frame[label == 2] = (40, 200, 90)
        noise = rng.integers(-12, 12, frame.shape)
        frame = np.clip(frame.astype(int) + noise, 0, 255).astype(np.uint8)
        Image.fromarray(frame).save(imgs / f'frame_{t:06d}.jpg', quality=95)
        if t in ANNOTATED:
            m = Image.fromarray(label, mode='P')
            m.putpalette(palette)
            m.save(anns / f'frame_{t:06d}.png')
    return imgs, anns


@pytest.fixture(scope='module')
def outputs(tmp_path_factory):
    root = tmp_path_factory.mktemp('video')
    imgs, anns = write_video(root)
    sd = synth_params()

    from xmem2_tpu.bridge.torch_params import convert_state_dict, save_params
    ckpt = root / 'synth.npz'
    save_params(convert_state_dict(sd), str(ckpt))

    from xmem2_tpu.inference import run_on_video as JR
    mp = pytest.MonkeyPatch()
    mp.setenv('XMEM2_FAST_STEP', '0')
    try:
        JR.run_on_video(str(imgs), str(anns), str(root / 'jax'),
                        frames_with_masks=ANNOTATED, print_progress=False,
                        save_overlay=False, overwrite_config=dict(
                            CONFIG, model=str(ckpt), chunk_frames=False))
    finally:
        mp.undo()

    from xmem2_tpu_torch.inference import run_on_video as TR
    from xmem2_tpu_torch.memory import manager as MM
    events = []

    def count(name, fn):
        def wrapped(*a, **k):
            events.append(name)
            return fn(*a, **k)
        return wrapped

    mp.setattr(MM, '_consolidate_kernel',
               count('consolidate', MM._consolidate_kernel))
    mp.setattr(MM.ST, 'evict_by_usage',
               count('evict', MM.ST.evict_by_usage))
    try:
        stats = TR.run_on_video(str(imgs), str(anns), str(root / 'torch'),
                                frames_with_masks=ANNOTATED,
                                print_progress=False, save_overlay=False,
                                device='cpu',
                                overwrite_config=dict(CONFIG, model=str(ckpt)))
    finally:
        mp.undo()
    return root, stats, events


def _masks(d):
    files = sorted((d / 'masks').glob('*.png'))
    return [np.asarray(Image.open(f).convert('RGB')) for f in files]


def test_masks_match_jax(outputs):
    root, stats, events = outputs
    assert events.count('consolidate') >= 2 and 'evict' in events, events
    ours, ref = _masks(root / 'torch'), _masks(root / 'jax')
    assert len(ours) == len(ref) == N_FRAMES
    assert len(stats) == N_FRAMES
    for t, (a, b) in enumerate(zip(ours, ref)):
        # equal masks; the tolerance admits at most 0.1% of pixels, for
        # argmax near-ties that float32 summation order could flip
        differ = float(np.any(a != b, axis=-1).mean())
        assert differ <= 1e-3, f'frame {t}: {differ:.4%} of pixels differ'
    # both objects are tracked after the second annotation
    colours = {tuple(c) for c in ours[-1].reshape(-1, 3)}
    assert len(colours) >= 2


def test_cli_on_cpu(outputs, tmp_path):
    """python -m xmem2_tpu_torch.process_video --device cpu (default
    memory settings, --exact) writes one mask per frame."""
    import os
    import subprocess
    import sys
    root = outputs[0]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, '-m', 'xmem2_tpu_torch.process_video',
         '--video', str(root / 'imgs'), '--masks', str(root / 'anns'),
         '--output', str(tmp_path), '--model', str(root / 'synth.npz'),
         '--exact', '--size', '-1', '--device', 'cpu'],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert len(list((tmp_path / 'masks').glob('*.png'))) == N_FRAMES


def _make_core(sd, cfg):
    from xmem2_tpu_torch.bridge.torch_params import build_model, \
        convert_state_dict
    from xmem2_tpu_torch.inference.core import InferenceCore
    from xmem2_tpu_torch.inference.net import XMemNet
    sd, dims = convert_state_dict(sd)
    net = XMemNet(build_model(sd, dims, device='cpu'), 'float32',
                  device='cpu')
    core = InferenceCore(net, cfg, device='cpu')
    core.set_all_labels([1])
    return core


def test_step_chunk_matches_per_frame_step():
    """step_chunk against the port's own per-frame step (the JAX chunked
    path failed its own 480p checksum gate, so per-frame is the oracle)."""
    from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG
    from xmem2_tpu_torch.inference.postprocess import unpack_mask
    cfg = dict(VIDEO_INFERENCE_CONFIG, **CONFIG)
    cfg.update(mem_every=4, max_mid_term_frames=6, min_mid_term_frames=3,
               top_k=10)
    sd = synth_params()
    rng = np.random.default_rng(7)
    n = 13
    frames = [rng.standard_normal((H, W, 3)).astype(np.float32) * 0.5
              for _ in range(n)]
    mask0 = np.zeros((1, H, W), np.float32)
    mask0[0, 20:40, 30:60] = 1

    a = _make_core(sd, cfg)
    packs_a = []
    for t in range(n):
        _, p = a.step(frames[t], mask0 if t == 0 else None,
                      [1] if t == 0 else None, end=(t == n - 1),
                      pack_hw=(H, W))
        packs_a.append(p.numpy())

    b = _make_core(sd, cfg)
    packs_b = [None] * n
    t, chunks = 0, 0
    while t < n:
        k = min(b.plain_run_length(), n - 1 - t) if t > 0 else 0
        if k > 0:
            for j, p in enumerate(b.step_chunk(frames[t:t + k], (H, W))):
                packs_b[t + j] = p.numpy()
            t += k
            chunks += 1
            continue
        _, p = b.step(frames[t], mask0 if t == 0 else None,
                      [1] if t == 0 else None, end=(t == n - 1),
                      pack_hw=(H, W))
        packs_b[t] = p.numpy()
        t += 1
    assert chunks >= 3, 'chunked path never exercised'

    for t in range(n):
        ma = unpack_mask(packs_a[t], W, a.pack_bits)
        mb = unpack_mask(packs_b[t], W, b.pack_bits)
        # same masks up to argmax near-ties under summation order (<= 0.1%)
        assert np.mean(ma != mb) <= 1e-3, f'frame {t}'
    assert a.curr_ti == b.curr_ti and a.last_mem_ti == b.last_mem_ti
    assert a.memory.temp_size == b.memory.temp_size
    # the chunk encodes keys at batch k, the per-frame path at batch 1: the
    # CPU convolutions then differ by ~1e-6 relative (selection up to 7e-5),
    # which the synthetic weights (GRU tanh inputs O(100)) amplify along the
    # 13-frame hidden chain to ~1e-3: tolerance 5e-3
    torch.testing.assert_close(b.memory.get_hidden(), a.memory.get_hidden(),
                               rtol=5e-3, atol=5e-3)
    torch.testing.assert_close(b.memory.temp.use_count,
                               a.memory.temp.use_count, rtol=5e-3, atol=5e-4)
    torch.testing.assert_close(b.memory.temp.life_count,
                               a.memory.temp.life_count, rtol=0, atol=0)


def test_step_chunk_rejects_oversized_run():
    from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG
    cfg = dict(VIDEO_INFERENCE_CONFIG, **CONFIG)
    core = _make_core(synth_params(), cfg)
    frames = np.zeros((6, H, W, 3), np.float32)
    mask0 = np.zeros((1, H, W), np.float32)
    mask0[0, 10:30, 10:30] = 1
    core.step(frames[0], mask0, [1])
    avail = core.plain_run_length()
    assert avail == cfg['mem_every'] - 1
    with pytest.raises(ValueError):
        core.step_chunk(frames[1:avail + 2], (H, W))
