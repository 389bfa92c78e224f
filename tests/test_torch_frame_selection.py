"""Annotation-candidate selection and the augmented permanent memory of the
port against xmem2_tpu, on the CPU:

  - the deterministic augmentation catalog, byte-equal for every subset;
  - the batched cycle dissimilarity against JAX `_cycle_dissim_batch`
    (rtol 1e-5; atol 1e-6 for a frame against itself, which is 0 up to
    float32 rounding in both);
  - select_next_candidates: equal choices over seeds, k, alpha and masks
    below min_mask_presence_percent;
  - select_k_next_best_annotation_candidates end to end on the 16-frame
    64x96 video of tests/test_torch_run_on_video.py, both branches, equal to
    JAX extract_keys + select_next_candidates fed the same binarised masks;
  - the JAX package failing on the RGB masks its own run_on_video writes
    (the departure the port makes on purpose);
  - run_on_video(augment_images_with_masks=True) against JAX's, f32: masks
    equal up to 0.1% of pixels, the tolerance of test_torch_run_on_video.

The JAX side runs its per-frame path (XMEM2_FAST_STEP=0, no chunking), as in
test_torch_run_on_video.py."""

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_run_on_video import (  # noqa: F401
    ANNOTATED, CONFIG, N_FRAMES, _masks, one_torch_thread, synth_params,
    write_video)

SUBSETS = ['best_3', 'best_3_with_symmetrical', 'best_all', 'original_only',
           'all']


def synth_keys(seed, n=12, h=6, w=8, ck=16, hh=48, ww=64):
    """Keys/shrinkages/selections channels-last, and [1, H, W] masks; every
    fifth frame's mask covers one pixel (below min_mask_presence_percent)."""
    rng = np.random.default_rng(seed)
    keys = rng.standard_normal((n, h, w, ck)).astype(np.float32)
    shrink = ((rng.standard_normal((n, h, w, 1)) ** 2) + 1).astype(np.float32)
    sel = (1 / (1 + np.exp(-rng.standard_normal((n, h, w, ck))))).astype(
        np.float32)
    masks = []
    for i in range(n):
        m = np.zeros((1, hh, ww), np.float32)
        if i % 5 == 3:
            m[0, :1, :1] = 1.0
        else:
            y, x = rng.integers(0, hh - 16), rng.integers(0, ww - 16)
            m[0, y:y + 16, x:x + 16] = 1.0
        masks.append(m)
    return keys, shrink, sel, masks


def binarised(masks_dir):
    """Saved RGB masks as [1, H, W] foreground: any channel non-zero."""
    return [np.asarray(Image.open(p).convert('RGB')).any(-1)[None]
            .astype(np.float32) for p in sorted(masks_dir.iterdir())]


@pytest.mark.parametrize('subset', SUBSETS)
def test_augmentations_byte_equal(subset):
    from xmem2_tpu.inference.frame_selection.utils import \
        get_determenistic_augmentations as jax_augs
    from xmem2_tpu_torch.inference.frame_selection.utils import \
        get_determenistic_augmentations as torch_augs
    rng = np.random.default_rng(3)
    img = Image.fromarray(rng.integers(0, 255, (40, 56, 3), dtype=np.uint8))
    mask = np.zeros((2, 40, 56), np.float32)
    mask[0, 5:20, 10:30] = 1
    mask[1, 22:35, 30:50] = 1
    ja = jax_augs((40, 56, 3), mask, subset=subset)
    ta = torch_augs((40, 56, 3), mask, subset=subset)
    assert len(ta) == len(ja) > 0
    for (ji, jm), (ti, tm) in zip(ja, ta):
        assert ti.name == ji.name and tm.name == jm.name
        np.testing.assert_array_equal(np.asarray(ti(img)),
                                      np.asarray(ji(img)), err_msg=ti.name)
        np.testing.assert_array_equal(tm(mask), jm(mask), err_msg=tm.name)


@pytest.mark.parametrize('seed', [0, 1])
def test_cycle_dissimilarity_matches_jax(seed):
    from xmem2_tpu.inference.frame_selection.frame_selection import \
        _cycle_dissim_batch
    from xmem2_tpu_torch.inference.frame_selection.frame_selection import \
        cycle_dissimilarity
    keys, shrink, sel, _ = synth_keys(seed)
    n, h, w, ck = keys.shape
    rows = (keys.reshape(n, h * w, ck), shrink.reshape(n, h * w),
            sel.reshape(n, h * w, ck))
    for c in (0, 5):
        args = [a[c] for a in rows] + list(rows)
        want = np.asarray(_cycle_dissim_batch(*args))
        got = cycle_dissimilarity(*map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert (want > 1e-3).sum() >= n - 1     # not a vacuous comparison


@pytest.mark.parametrize('alpha', [0.0, 0.5, 1.0])
@pytest.mark.parametrize('seed,k,prev', [(0, 3, (0,)), (1, 4, (0, 5)),
                                         (2, 2, (7,))])
def test_select_next_candidates_matches_jax(seed, k, prev, alpha):
    from xmem2_tpu.inference.frame_selection.frame_selection import \
        select_next_candidates as jax_select
    from xmem2_tpu_torch.inference.frame_selection import \
        select_next_candidates as torch_select
    keys, shrink, sel, masks = synth_keys(seed)
    kw = dict(num_next_candidates=k, previously_chosen_candidates=list(prev),
              alpha=alpha, min_mask_presence_percent=0.25)
    want = jax_select(keys, shrink, sel, masks, **kw)
    got = torch_select(torch.from_numpy(keys), shrink, sel, masks,
                       device='cpu', **kw)
    assert got == [int(i) for i in want]
    assert not {3, 8} & set(got)           # frames with too small masks


@pytest.fixture(scope='module')
def video(tmp_path_factory):
    """The 16-frame video, its checkpoint, and the augmented runs of both
    packages (the port's run also records its permanent memory)."""
    root = tmp_path_factory.mktemp('video')
    imgs, anns = write_video(root)
    from xmem2_tpu.bridge.torch_params import convert_state_dict, save_params
    ckpt = root / 'synth.npz'
    save_params(convert_state_dict(synth_params()), str(ckpt))

    from xmem2_tpu.inference import run_on_video as JR
    mp = pytest.MonkeyPatch()
    mp.setenv('XMEM2_FAST_STEP', '0')
    try:
        JR.run_on_video(str(imgs), str(anns), str(root / 'jax_aug'),
                        frames_with_masks=ANNOTATED, print_progress=False,
                        save_overlay=False, augment_images_with_masks=True,
                        overwrite_config=dict(CONFIG, model=str(ckpt),
                                              chunk_frames=False))
    finally:
        mp.undo()

    from xmem2_tpu_torch.inference import run_on_video as TR
    cores = []

    def preload(frames, reader, mapper, processor, **kw):
        cores.append(processor)
        return preload_fn(frames, reader, mapper, processor, **kw)

    preload_fn = TR._preload_permanent_memory
    mp.setattr(TR, '_preload_permanent_memory', preload)
    try:
        TR.run_on_video(str(imgs), str(anns), str(root / 'torch_aug'),
                        frames_with_masks=ANNOTATED, print_progress=False,
                        save_overlay=False, augment_images_with_masks=True,
                        device='cpu',
                        overwrite_config=dict(CONFIG, model=str(ckpt)))
    finally:
        mp.undo()
    return dict(root=root, imgs=imgs, anns=anns, ckpt=ckpt,
                memory=cores[0].memory)


def test_augmented_run_matches_jax(video):
    root = video['root']
    ours, ref = _masks(root / 'torch_aug'), _masks(root / 'jax_aug')
    assert len(ours) == len(ref) == N_FRAMES
    for t, (a, b) in enumerate(zip(ours, ref)):
        differ = float(np.any(a != b, axis=-1).mean())
        assert differ <= 1e-3, f'frame {t}: {differ:.4%} of pixels differ'
    # 2 annotated frames and 11 augmentations of each; only the annotated
    # frames have an index
    mm = video['memory']
    assert mm.perm_size == 2 * 12 * mm.HW
    assert sorted(mm.frame_id_to_permanent_mem_idx) == list(ANNOTATED)


def test_jax_reads_its_own_masks_wrong(video):
    """The JAX select_k reads its run_on_video's RGB PNGs as [1, H, W, 3]
    (xmem2_tpu/inference/run_on_video.py:368) and its selection fails on
    them (frame_selection.py:95-97); the port's foreground read-back of the
    same files selects."""
    from xmem2_tpu.inference.frame_selection.frame_selection import \
        select_next_candidates as jax_select
    from xmem2_tpu_torch.inference.frame_selection import \
        select_next_candidates as torch_select
    from xmem2_tpu_torch.inference.run_on_video import read_foreground_masks
    files = sorted((video['root'] / 'jax_aug' / 'masks').iterdir())
    jax_way = [np.asarray(Image.open(p), np.float32)[None] / 255.0
               for p in files]
    assert jax_way[0].shape[-1] == 3
    keys, shrink, sel, _ = synth_keys(0, n=len(files))
    with pytest.raises(ValueError, match='reshape'):
        jax_select(keys, shrink, sel, jax_way, 2)
    ours = read_foreground_masks(video['root'] / 'jax_aug' / 'masks')
    assert ours[0].shape == (1,) + jax_way[0].shape[1:3]
    assert len(torch_select(keys, shrink, sel, ours, 2, device='cpu')) == 2


@pytest.fixture(scope='module')
def jax_keys(video):
    """JAX extract_keys over the video (host-preprocessed frames, f32)."""
    import jax.numpy as jnp
    from xmem2_tpu.bridge.torch_params import load_any
    from xmem2_tpu.config import VIDEO_INFERENCE_CONFIG
    from xmem2_tpu.inference.core import InferenceCore
    from xmem2_tpu.inference.data.video_reader import VideoReader
    from xmem2_tpu.inference.frame_selection.utils import extract_keys
    from xmem2_tpu.inference.net import XMemNet
    cfg = dict(VIDEO_INFERENCE_CONFIG, **CONFIG)
    core = InferenceCore(XMemNet(load_any(str(video['ckpt'])),
                                 compute_dtype=jnp.float32), config=cfg)
    reader = VideoReader('', str(video['imgs']), str(video['anns']),
                         size=cfg['size'], use_all_masks=True)
    return [np.concatenate(a) for a in extract_keys(reader, core)]


@pytest.mark.parametrize('use_previous', [True, False])
def test_select_k_matches_jax(video, jax_keys, use_previous):
    from xmem2_tpu.inference.frame_selection.frame_selection import \
        select_next_candidates as jax_select
    from xmem2_tpu_torch.inference.run_on_video import \
        select_k_next_best_annotation_candidates
    out = video['root'] / ('torch_aug' if use_previous else 'select_run')
    prev = (0,) if use_previous else ANNOTATED
    got = select_k_next_best_annotation_candidates(
        str(video['imgs']), str(video['anns']), masks_out_path=out, k=3,
        print_progress=False, previously_chosen_candidates=prev,
        use_previously_predicted_masks=use_previous, device='cpu',
        save_overlay=False,
        overwrite_config=dict(CONFIG, model=str(video['ckpt'])))
    masks = binarised(out / 'masks')
    assert len(masks) == N_FRAMES
    want = jax_select(*jax_keys, masks, 3,
                      previously_chosen_candidates=list(prev))
    assert got == [int(i) for i in want]
    assert len(set(got)) == 3 and not set(got) & set(prev)
