"""run_on_video: the product's main inference path.

Counterpart of xmem2_tpu/inference/run_on_video.py (reference
inference/run_on_video.py: run_on_video :247, _inference_on_video :31,
_preload_permanent_memory :201, select_k_next_best_annotation_candidates
:285). Runs on CUDA unless the caller passes device='cpu'. Annotated frames
are preloaded into permanent memory (optionally with 11 augmented copies
each); runs of steady-state frames go through InferenceCore.step_chunk;
masks are resized, argmaxed and bit-packed on the device and copied back
`pipeline_depth` frames behind, so the copy overlaps compute on the next
frames.
"""

import os
from collections import deque
from pathlib import Path
from tempfile import TemporaryDirectory
from time import perf_counter
from typing import Iterable, List, Optional, Union
from warnings import warn

import numpy as np
import torch
from PIL import Image

from xmem2_tpu_torch.bridge.torch_params import load_model
from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG, resolve_device
from xmem2_tpu_torch.inference.core import InferenceCore
from xmem2_tpu_torch.inference.data.mask_mapper import MaskMapper
from xmem2_tpu_torch.inference.data.video_reader import VideoReader
from xmem2_tpu_torch.inference.frame_selection.frame_selection import \
    select_candidates_from_rows
from xmem2_tpu_torch.inference.frame_selection.utils import (
    extract_keys, get_determenistic_augmentations)
from xmem2_tpu_torch.inference.net import XMemNet
from xmem2_tpu_torch.inference.postprocess import unpack_mask
from xmem2_tpu_torch.utils.image_saver import ParallelImageSaver
from xmem2_tpu_torch.utils.iou import compute_array_iou


def _load_main_objects(imgs_in_path, masks_in_path, config, device,
                       shard_devices=None):
    model_path = config.get('model')
    if model_path is None or not os.path.exists(str(model_path)):
        raise FileNotFoundError(f'model checkpoint not found: {model_path}')
    network = XMemNet(load_model(model_path, device),
                      config.get('compute_dtype', 'auto'), device)
    processor = InferenceCore(network, config=config, device=device,
                              shard_devices=shard_devices)
    return MaskMapper(), processor, _create_reader(imgs_in_path,
                                                   masks_in_path, config)


def _create_reader(imgs_in_path, masks_in_path, config) -> VideoReader:
    vid_reader = VideoReader(
        '', imgs_in_path, masks_in_path, size=config['size'],
        use_all_masks=True,
        host_preprocess=not config.get('device_preprocess', True))
    # no need to count long-term usage on a short video (reference :190-196)
    config['enable_long_term_count_usage'] = (
        config['enable_long_term'] and
        (len(vid_reader)
         / (config['max_mid_term_frames'] - config['min_mid_term_frames'])
         * config['num_prototypes'])
        >= config['max_long_term_elements'])
    return vid_reader


def _preload_permanent_memory(frames_to_put_in_permanent_memory: List[int],
                              vid_reader: VideoReader, mapper: MaskMapper,
                              processor: InferenceCore,
                              augment_images_with_masks: bool = False):
    """Each frame's image and mask into permanent memory under its index;
    with augment_images_with_masks, also the 11 'best_all' augmentations of
    each (JAX run_on_video.py:97-113), without an index (ti=None): the image
    is augmented in raw space, then normalised and resized on the host; the
    mask is augmented after its resize."""
    total_preloading_time = 0.0
    at_least_one_mask_loaded = False
    for j in frames_to_put_in_permanent_memory:
        sample = vid_reader[j]
        frame_rgb = sample.rgb if sample.rgb is not None else sample.rgb_u8
        if sample.mask is None:
            raise FileNotFoundError(
                f"Couldn't find mask {j}! Check that the filename matches the "
                f"frame or follows the `frame_%06d.png` format.")
        msk, _ = mapper.convert_mask(sample.mask, exhaustive=True)
        if min(msk.shape) == 0:
            warn(f'Skipping adding frame {j} to permanent memory: empty mask')
            continue
        if sample.need_resize:
            msk = vid_reader.resize_mask(msk)
        processor.set_all_labels(list(mapper.remappings.values()))
        a = perf_counter()
        processor.put_to_permanent_memory(frame_rgb, msk, ti=j)
        if augment_images_with_masks:
            # translate_distance comes from the resized (H, W), as in the
            # reference (run_on_video.py:232-233); frame_rgb may be the raw
            # frame under device preprocessing and must not be used here
            augs = get_determenistic_augmentations(
                (msk.shape[-2], msk.shape[-1], 3), msk, subset='best_all')
            for img_aug, mask_aug in augs:
                processor.put_to_permanent_memory(
                    vid_reader.im_transform(img_aug(sample.raw_image_pil)),
                    mask_aug(np.asarray(msk)))
        total_preloading_time += perf_counter() - a
        at_least_one_mask_loaded = True
    return at_least_one_mask_loaded, total_preloading_time


class _MaskFetcher:
    """Packed masks in flight from the device: each is copied to host memory
    without blocking and waited for `depth` frames later."""

    def __init__(self, depth: int, finish):
        self.depth = max(depth, 1)
        self.finish = finish
        self.inflight = deque()

    def submit(self, ti, sample, packed: torch.Tensor, width, bits, provided):
        event = None
        if packed.is_cuda:
            packed = packed.to('cpu', non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        self.inflight.append((ti, sample, packed, event, width, bits,
                              provided))
        while len(self.inflight) >= self.depth:
            self.drain_one()

    def drain_one(self):
        ti, sample, packed, event, width, bits, provided = \
            self.inflight.popleft()
        if event is not None:
            event.synchronize()
        self.finish(ti, sample, unpack_mask(packed.numpy(), width, bits),
                    provided)

    def drain(self):
        while self.inflight:
            self.drain_one()


def _inference_on_video(frames_with_masks, imgs_in_path, masks_in_path,
                        masks_out_path, original_memory_mechanism=False,
                        compute_iou=False, manually_curated_masks=False,
                        print_progress=True, augment_images_with_masks=False,
                        overwrite_config: Optional[dict] = None,
                        save_overlay=True,
                        object_color_if_single_object=(255, 255, 255),
                        print_fps=False, image_saving_max_queue_size=200,
                        device=None, shard_devices=None):
    device = resolve_device(device)
    frames_with_masks = set(frames_with_masks)
    config = VIDEO_INFERENCE_CONFIG.copy()
    config.update(overwrite_config or {})
    config['masks_out_path'] = masks_out_path

    mapper, processor, vid_reader = _load_main_objects(
        imgs_in_path, masks_in_path, config, device, shard_devices)
    vid_length = len(vid_reader)

    preload = [0] if original_memory_mechanism else sorted(frames_with_masks)
    loaded, total_preloading_time = _preload_permanent_memory(
        preload, vid_reader, mapper, processor,
        augment_images_with_masks=augment_images_with_masks)
    if not loaded:
        raise ValueError('No valid masks provided!')

    # runs of plain frames go through step_chunk (same semantics, one batched
    # key encoding and readout per run)
    use_chunks = bool(config.get('chunk_frames', True)) \
        and not manually_curated_masks

    stats = []
    with ParallelImageSaver(
            config['masks_out_path'], vid_name=vid_reader.vid_name,
            overlay_color_if_b_and_w=object_color_if_single_object,
            max_queue_size=image_saving_max_queue_size) as im_saver:

        def finish_frame(ti, sample, out_mask, mask_provided):
            curr_stat = {'frame': sample.frame, 'mask_provided': mask_provided}
            if compute_iou:
                gt = sample.mask
                if gt is not None and not mask_provided:
                    curr_stat['iou'] = float(compute_array_iou(out_mask, gt))
                else:
                    curr_stat['iou'] = -1  # the model saw this GT
            stats.append(curr_stat)
            if config['save_masks']:
                out_img = vid_reader.map_the_colors_back(
                    Image.fromarray(mapper.remap_index_mask(out_mask)))
                im_saver.save_mask(mask=out_img, frame_name=sample.frame)
                if save_overlay:
                    im_saver.save_overlay(orig_img=sample.raw_image_pil,
                                          mask=out_img,
                                          frame_name=sample.frame)

        fetcher = _MaskFetcher(int(config.get('pipeline_depth', 4)),
                               finish_frame)
        # peekable buffer over the reader's prefetching iterator
        sample_iter = iter(vid_reader)
        lookahead = deque()

        def peek(j):
            while len(lookahead) <= j:
                lookahead.append(next(sample_iter))
            return lookahead[j]

        loop_start = perf_counter()
        ti = 0
        while ti < vid_length:
            sample = peek(0)
            out_hw = tuple(int(x) for x in sample.shape)

            k = 0
            if use_chunks and ti not in frames_with_masks:
                k = min(processor.plain_run_length(), vid_length - 1 - ti)
                while any((ti + j) in frames_with_masks for j in range(k)):
                    k -= 1
            if k > 1:
                chunk = [peek(j) for j in range(k)]
                for _ in range(k):
                    lookahead.popleft()
                packs = processor.step_chunk(
                    [s.rgb if s.rgb is not None else s.rgb_u8 for s in chunk],
                    pack_hw=out_hw)
                for j, s in enumerate(chunk):
                    fetcher.submit(ti + j, s, packs[j], out_hw[1],
                                   processor.pack_bits, False)
                ti += k
                continue

            frame_rgb = sample.rgb if sample.rgb is not None \
                else sample.rgb_u8
            msk = labels = None
            if ti in frames_with_masks and sample.mask is not None:
                msk, labels = mapper.convert_mask(sample.mask, exhaustive=True)
                if sample.need_resize:
                    msk = vid_reader.resize_mask(msk)
                processor.set_all_labels(list(mapper.remappings.values()))
            do_not_add_mask_to_memory = (ti == 0) if original_memory_mechanism \
                else msk is not None

            _, packed = processor.step(
                frame_rgb, msk, labels, end=(ti == vid_length - 1),
                manually_curated_masks=manually_curated_masks,
                do_not_add_mask_to_memory=do_not_add_mask_to_memory,
                pack_hw=out_hw)
            fetcher.submit(ti, sample, packed, out_hw[1], processor.pack_bits,
                           msk is not None)
            lookahead.popleft()
            ti += 1
            if print_progress and ti % 50 == 0:
                print(f'{ti}/{vid_length} frames')
        fetcher.drain()
        total_processing_time = perf_counter() - loop_start
        im_saver.wait_for_jobs_to_finish(verbose=print_progress)

    if print_fps:
        # whole-loop wall clock: includes host frame decode waits, mask
        # unpacking and IoU post-processing
        print(f'TOTAL PRELOADING TIME: {total_preloading_time:.4f}s')
        print(f'TOTAL PROCESSING TIME (end-to-end wall clock): '
              f'{total_processing_time:.4f}s')
        print(f'TOTAL PROCESSING FPS (end-to-end wall clock): '
              f'{vid_length / total_processing_time:.4f}')
    try:
        import pandas as pd
    except ImportError:   # pandas is optional: rows as a list of dicts
        return stats
    return pd.DataFrame(stats)


def run_on_video(
    imgs_in_path: Union[str, os.PathLike],
    masks_in_path: Union[str, os.PathLike],
    masks_out_path: Union[str, os.PathLike],
    frames_with_masks: Iterable[int] = (0,),
    compute_iou=False,
    print_progress=True,
    device=None,
    shard_devices=None,
    **kwargs,
):
    """Run inference on a video (signature of the reference run_on_video,
    inference/run_on_video.py:247-282, plus `device`: CUDA unless 'cpu' is
    passed, and `shard_devices`: with overwrite_config={'memory_shards': D},
    the devices of the D memory shards, by default the first D visible).
    Returns one row per frame ('frame', 'mask_provided' and, with
    compute_iou, 'iou'): a pandas DataFrame where pandas is installed, else
    a list of dicts."""
    return _inference_on_video(
        imgs_in_path=imgs_in_path, masks_in_path=masks_in_path,
        masks_out_path=masks_out_path, frames_with_masks=frames_with_masks,
        compute_iou=compute_iou, print_progress=print_progress,
        device=device, shard_devices=shard_devices, **kwargs)


def read_foreground_masks(masks_dir: Union[str, os.PathLike]
                          ) -> List[np.ndarray]:
    """The masks run_on_video saved (RGB PNGs, sorted by name) as [1, H, W]
    float32 foreground masks: 1.0 where any channel is non-zero, else 0.0.

    This departs from the JAX package on purpose: its read-back,
    `np.asarray(Image.open(p), np.float32)[None] / 255`
    (xmem2_tpu/inference/run_on_video.py:368, :382), gives [1, H, W, 3] for
    the RGB files its own run_on_video writes, which its
    select_next_candidates cannot resize (ValueError at
    frame_selection.py:97). The union of the objects is what
    select_next_candidates computes from [O, H, W] masks anyway
    (frame_selection.py:88)."""
    return [np.asarray(Image.open(p).convert('RGB')).any(axis=-1)[None]
            .astype(np.float32)
            for p in sorted(Path(masks_dir).iterdir())]


def select_k_next_best_annotation_candidates(
    imgs_in_path: Union[str, os.PathLike],
    masks_in_path: Union[str, os.PathLike],
    masks_out_path: Optional[Union[str, os.PathLike]] = None,
    k: int = 5,
    print_progress=True,
    previously_chosen_candidates=(0,),
    use_previously_predicted_masks=True,
    alpha=0.5,
    min_mask_presence_percent=0.25,
    device=None,
    **kwargs,
) -> List[int]:
    """The k frames best to annotate next (signature of the reference,
    run_on_video.py:285-370, plus `device`: CUDA unless 'cpu' is passed).

    With use_previously_predicted_masks the masks are read from
    `masks_out_path`/masks; without, run_on_video first propagates the
    previously chosen annotations (into `masks_out_path`, or a temporary
    directory). kwargs go to run_on_video; their `overwrite_config` also
    configures the key extraction (model, size). Masks are read back as
    foreground masks (read_foreground_masks), not as the JAX package reads
    them. Returns the new frame indices."""
    device = resolve_device(device)
    config = VIDEO_INFERENCE_CONFIG.copy()
    config.update(kwargs.get('overwrite_config') or {})
    _, processor, vid_reader = _load_main_objects(
        imgs_in_path, masks_in_path, config, device)
    keys, shrinkages, selections = extract_keys(
        vid_reader, processor, print_progress=print_progress)

    with TemporaryDirectory() as tmp:
        if use_previously_predicted_masks:
            if masks_out_path is None:
                raise ValueError(
                    'use_previously_predicted_masks=True needs the path of '
                    'the previously predicted masks in masks_out_path')
            masks = read_foreground_masks(Path(masks_out_path) / 'masks')
        else:
            out = Path(tmp if masks_out_path is None else masks_out_path)
            run_on_video(imgs_in_path, masks_in_path, out,
                         frames_with_masks=previously_chosen_candidates,
                         compute_iou=False, print_progress=print_progress,
                         device=device, **kwargs)
            masks = read_foreground_masks(out / 'masks')
    if len(masks) != len(keys):
        raise FileNotFoundError(
            f'{len(masks)} masks for {len(keys)} frames')

    n, ck, h, w = keys.shape
    return select_candidates_from_rows(
        keys.flatten(2).mT, shrinkages.flatten(1), selections.flatten(2).mT,
        (h, w), masks, k,
        previously_chosen_candidates=list(previously_chosen_candidates),
        print_progress=print_progress, alpha=alpha, only_new_candidates=True,
        min_mask_presence_percent=min_mask_presence_percent)
