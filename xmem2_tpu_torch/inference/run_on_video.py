"""run_on_video: the product's main inference path.

Counterpart of xmem2_tpu/inference/run_on_video.py (reference
inference/run_on_video.py: run_on_video :247, _inference_on_video :31,
_preload_permanent_memory :201). Runs on CUDA unless the caller passes
device='cpu'. Annotated frames are preloaded into permanent memory; runs of
steady-state frames go through InferenceCore.step_chunk; masks are resized,
argmaxed and bit-packed on the device and copied back `pipeline_depth`
frames behind, so the copy overlaps compute on the next frames.
"""

import os
from collections import deque
from time import perf_counter
from typing import Iterable, List, Optional, Union
from warnings import warn

import torch
from PIL import Image

from xmem2_tpu_torch.bridge.torch_params import load_model
from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG, resolve_device
from xmem2_tpu_torch.inference.core import InferenceCore
from xmem2_tpu_torch.inference.data.mask_mapper import MaskMapper
from xmem2_tpu_torch.inference.data.video_reader import VideoReader
from xmem2_tpu_torch.inference.net import XMemNet
from xmem2_tpu_torch.inference.postprocess import unpack_mask
from xmem2_tpu_torch.utils.image_saver import ParallelImageSaver
from xmem2_tpu_torch.utils.iou import compute_array_iou

_FRAME_SELECTION = ('frame selection is not ported yet: ROADMAP.md Queue 1 '
                    'item 8')


def _load_main_objects(imgs_in_path, masks_in_path, config, device):
    model_path = config.get('model')
    if model_path is None or not os.path.exists(str(model_path)):
        raise FileNotFoundError(f'model checkpoint not found: {model_path}')
    network = XMemNet(load_model(model_path), config.get('compute_dtype',
                                                         'auto'), device)
    processor = InferenceCore(network, config=config, device=device)
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
    if augment_images_with_masks:
        raise NotImplementedError(_FRAME_SELECTION)
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
                        device=None):
    if augment_images_with_masks:
        raise NotImplementedError(_FRAME_SELECTION)
    device = resolve_device(device)
    frames_with_masks = set(frames_with_masks)
    config = VIDEO_INFERENCE_CONFIG.copy()
    config.update(overwrite_config or {})
    config['masks_out_path'] = masks_out_path

    mapper, processor, vid_reader = _load_main_objects(
        imgs_in_path, masks_in_path, config, device)
    vid_length = len(vid_reader)

    preload = [0] if original_memory_mechanism else sorted(frames_with_masks)
    loaded, total_preloading_time = _preload_permanent_memory(
        preload, vid_reader, mapper, processor)
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
    **kwargs,
):
    """Run inference on a video (signature of the reference run_on_video,
    inference/run_on_video.py:247-282, plus `device`: CUDA unless 'cpu' is
    passed). Returns one row per frame ('frame', 'mask_provided' and, with
    compute_iou, 'iou'): a pandas DataFrame where pandas is installed, else
    a list of dicts."""
    return _inference_on_video(
        imgs_in_path=imgs_in_path, masks_in_path=masks_in_path,
        masks_out_path=masks_out_path, frames_with_masks=frames_with_masks,
        compute_iou=compute_iou, print_progress=print_progress,
        device=device, **kwargs)


def select_k_next_best_annotation_candidates(*args, **kwargs):
    """Annotation-candidate selection (reference run_on_video.py:285-370)."""
    raise NotImplementedError(_FRAME_SELECTION)
