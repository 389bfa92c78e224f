"""Benchmark evaluation with the PyTorch/CUDA port over DAVIS, YouTube-VOS,
the long-video set or a generic folder of videos:

    python -m xmem2_tpu_torch.eval --dataset G --generic_path <root> \
        --model <ckpt.pth|.npz> --output <dir>

Counterpart of the root eval.py (reference eval.py:28-257): the same flags
plus --device, the same per-video loop (frames before the first mask are
skipped, runs of mask-less frames go through InferenceCore.step_chunk,
masks are exhaustive except on YouTube-VOS), the FPS and peak-memory
report, palette PNGs, score dumps for merge_multi_scale (Scores/<video>/
<frame>.npz and backward.json) and the zips for submission. On the card,
--benchmark synchronises the device on every frame, the peak memory is
torch.cuda.max_memory_allocated() and --profile_dir writes a torch.profiler
trace (utils/profiling.device_trace). Runs on CUDA unless --device cpu is
given.
"""

import json
import os
import shutil
import time
from argparse import ArgumentParser
from collections import deque
from os import path

import numpy as np
import torch
from PIL import Image

from xmem2_tpu_torch.bridge.torch_params import load_model
from xmem2_tpu_torch.config import VIDEO_INFERENCE_CONFIG, resolve_device
from xmem2_tpu_torch.inference.core import InferenceCore
from xmem2_tpu_torch.inference.data.mask_mapper import MaskMapper
from xmem2_tpu_torch.inference.data.test_datasets import (
    DAVISTestDataset, GenericTestDataset, LongTestDataset,
    YouTubeVOSTestDataset)
from xmem2_tpu_torch.inference.net import XMemNet
from xmem2_tpu_torch.inference.postprocess import unpack_mask
from xmem2_tpu_torch.utils.profiling import device_trace
from xmem2_tpu_torch.utils.resize_np import resize_bilinear_np


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument('--model', default='./saves/XMem.npz')
    parser.add_argument('--d16_path', default='../DAVIS/2016')
    parser.add_argument('--d17_path', default='../DAVIS/2017')
    parser.add_argument('--y18_path', default='../YouTube2018')
    parser.add_argument('--y19_path', default='../YouTube')
    parser.add_argument('--lv_path', default='../long_video_set')
    parser.add_argument('--generic_path')
    parser.add_argument('--dataset', default='D17',
                        help='D16/D17/Y18/Y19/LV1/LV3/G')
    parser.add_argument('--split', default='val')
    parser.add_argument('--output', default=None)
    parser.add_argument('--save_all', action='store_true')
    parser.add_argument('--benchmark', action='store_true',
                        help='synchronise the device on every frame, so the '
                             'reported time is the device\'s')
    parser.add_argument('--disable_long_term', action='store_true')
    parser.add_argument('--max_mid_term_frames', type=int, default=10)
    parser.add_argument('--min_mid_term_frames', type=int, default=5)
    parser.add_argument('--max_long_term_elements', type=int, default=10000)
    parser.add_argument('--num_prototypes', type=int, default=128)
    parser.add_argument('--top_k', type=int, default=30)
    parser.add_argument('--mem_every', type=int, default=5)
    parser.add_argument('--deep_update_every', type=int, default=-1)
    parser.add_argument('--save_scores', action='store_true')
    parser.add_argument('--size', type=int, default=480,
                        help='resize shorter side, -1 for original')
    parser.add_argument('--compute_dtype', default='auto',
                        choices=['auto', 'float32', 'bfloat16'],
                        help="'auto' = bfloat16 on CUDA, float32 on the CPU")
    parser.add_argument('--exact', action='store_true',
                        help='float32 compute and float32 memory value '
                             'stores; overrides --compute_dtype')
    parser.add_argument('--chunked', default=True, action='store_true',
                        help='run plain-frame runs through '
                             'InferenceCore.step_chunk (default on)')
    parser.add_argument('--no_chunked', dest='chunked', action='store_false')
    parser.add_argument('--memory_shards', type=int, default=0,
                        help='split the memory banks over this many GPUs '
                             '(the first ones visible); 0 or 1: one device')
    parser.add_argument('--profile_dir', default=None,
                        help='write a torch.profiler trace (trace.json) '
                             'here')
    parser.add_argument('--spill_long_term', action='store_true',
                        help='archive evicted long-term memory rows in host '
                             'memory instead of discarding them')
    parser.add_argument('--device', default=None,
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    if args.exact:
        args.compute_dtype = 'float32'
    return args


def _dataset(args, is_youtube, is_davis, is_lv):
    """The dataset of --dataset/--split (reference eval.py:77-129)."""
    if is_youtube:
        if args.split == 'val':
            args.split = 'valid'      # YouTube-VOS names its validation split
        root = args.y18_path if args.dataset == 'Y18' else args.y19_path
        return YouTubeVOSTestDataset(root, args.split, size=args.size)
    if is_davis:
        if args.dataset == 'D16':
            if args.split != 'val':
                raise NotImplementedError('D16 has only the val split')
            return GenericTestDataset(path.join(args.d16_path, 'trainval'),
                                      size=args.size)
        imset = {'val': '2017/val.txt', 'test': '2017/test-dev.txt'}[
            args.split]
        return DAVISTestDataset(
            args.d17_path if args.split == 'val'
            else path.join(args.d17_path, 'trainval'),
            imset=imset, size=args.size)
    if is_lv:
        return LongTestDataset(
            path.join(args.lv_path, {'LV1': 'long_video',
                                     'LV3': 'long_video_x3'}[args.dataset]),
            size=args.size)
    if args.dataset == 'G':
        return GenericTestDataset(args.generic_path, size=args.size)
    raise NotImplementedError(args.dataset)


def _frame(sample):
    return sample.rgb if sample.rgb is not None else sample.rgb_u8


def _eval_video(vid_reader, network, config, args, out_path, is_youtube,
                device):
    """One video (reference eval.py:151-247). Returns (seconds, frames)."""
    vid_name = vid_reader.vid_name
    vid_length = len(vid_reader)
    # long-term usage counting pays only on long videos (reference
    # eval.py:154-160); it is set per video, so each gets its own core
    config['enable_long_term_count_usage'] = (
        config['enable_long_term'] and
        (vid_length / (config['max_mid_term_frames'] -
                       config['min_mid_term_frames'])
         * config['num_prototypes']) >= config['max_long_term_elements'])
    mapper = MaskMapper()
    processor = InferenceCore(network, config=config, device=device)
    sync = torch.cuda.synchronize if (args.benchmark and
                                      device.type == 'cuda') else None
    palette = vid_reader.get_palette()
    seconds, frames = 0.0, 0

    def save_frame(sample, out_mask):
        if args.save_all or sample.save:
            this_out_path = path.join(out_path, vid_name)
            os.makedirs(this_out_path, exist_ok=True)
            out_img = Image.fromarray(mapper.remap_index_mask(out_mask))
            if palette is not None:
                out_img.putpalette(palette)
            out_img.save(path.join(this_out_path, sample.frame[:-4] + '.png'))

    # peekable buffer over the reader's prefetching iterator
    sample_iter = iter(vid_reader)
    lookahead = deque()

    def peek(j):
        while len(lookahead) <= j:
            lookahead.append(next(sample_iter))
        return lookahead[j]

    first_mask_loaded = False
    ti = 0
    while ti < vid_length:
        sample = peek(0)
        out_hw = tuple(int(x) for x in sample.shape)
        a = time.perf_counter()
        msk = sample.mask
        if not first_mask_loaded:
            if msk is None:            # nothing to segment before a mask
                lookahead.popleft()
                ti += 1
                continue
            first_mask_loaded = True

        if args.chunked and not args.save_scores and msk is None:
            k = min(processor.plain_run_length(), vid_length - 1 - ti)
            chunk = [sample]
            for j in range(1, k):
                s = peek(j)
                if s.mask is not None:
                    break
                chunk.append(s)
            if len(chunk) > 1:
                packs = processor.step_chunk([_frame(s) for s in chunk],
                                             pack_hw=out_hw)
                if sync:
                    sync()
                packs = [p.cpu().numpy() for p in packs]
                seconds += time.perf_counter() - a
                frames += len(chunk)
                for s, p in zip(chunk, packs):
                    save_frame(s, unpack_mask(p, out_hw[1],
                                              processor.pack_bits))
                    lookahead.popleft()
                ti += len(chunk)
                continue

        labels = None
        if msk is not None:
            msk, labels = mapper.convert_mask(msk, exhaustive=not is_youtube)
            if sample.need_resize:
                msk = vid_reader.resize_mask(msk)
            processor.set_all_labels(list(mapper.remappings.values()))
        end = ti == vid_length - 1
        if args.save_scores:
            # the score dump needs the whole probability map on the host
            prob = processor.step(_frame(sample), msk, labels, end=end)
            if sync:
                sync()
            prob_np = prob.float().cpu().numpy()
            if sample.need_resize:
                prob_np = np.stack([
                    resize_bilinear_np(c[..., None], out_hw)[..., 0]
                    for c in prob_np])
            out_mask = np.argmax(prob_np, axis=0).astype(np.uint8)
        else:
            _, packed = processor.step(_frame(sample), msk, labels, end=end,
                                       pack_hw=out_hw)
            if sync:
                sync()
            out_mask = unpack_mask(packed.cpu().numpy(), out_hw[1],
                                   processor.pack_bits)
        seconds += time.perf_counter() - a
        frames += 1

        if args.save_scores:
            prob_dir = path.join(args.output, 'Scores', vid_name)
            os.makedirs(prob_dir, exist_ok=True)
            if end:
                # label remappings for merge_multi_scale's backward remap
                # (reference eval.py:241 dumps backward.hkl the same way)
                with open(path.join(prob_dir, 'backward.json'), 'w') as f:
                    json.dump(mapper.remappings, f)
            np.savez_compressed(path.join(prob_dir, f'{sample.frame[:-4]}.npz'),
                                prob=(prob_np * 255).astype(np.uint8))
        save_frame(sample, out_mask)
        lookahead.popleft()
        ti += 1
    return seconds, frames


def main(argv=None) -> dict:
    """Evaluate; returns {'seconds', 'frames', 'fps', 'peak_memory_mb'}
    (peak memory None on the CPU) besides printing them."""
    args = parse_args(argv)
    config = VIDEO_INFERENCE_CONFIG.copy()
    config.update({
        'model': args.model, 'size': args.size, 'top_k': args.top_k,
        'mem_every': args.mem_every,
        'deep_update_every': args.deep_update_every,
        'enable_long_term': not args.disable_long_term,
        'max_mid_term_frames': args.max_mid_term_frames,
        'min_mid_term_frames': args.min_mid_term_frames,
        'max_long_term_elements': args.max_long_term_elements,
        'num_prototypes': args.num_prototypes,
        'compute_dtype': args.compute_dtype,
        'value_store_dtype': 'float32' if args.exact else
                             VIDEO_INFERENCE_CONFIG['value_store_dtype'],
        'spill_long_term': args.spill_long_term,
        'memory_shards': args.memory_shards,
    })
    device = resolve_device(args.device)

    if args.output is None:
        args.output = f'../output/{args.dataset}_{args.split}'
        print(f'Output path not provided. Defaulting to {args.output}')
    is_youtube = args.dataset.startswith('Y')
    is_davis = args.dataset.startswith('D')
    is_lv = args.dataset.startswith('LV')
    out_path = path.join(args.output, 'Annotations') \
        if (is_youtube or args.save_scores) else args.output
    meta_dataset = _dataset(args, is_youtube, is_davis, is_lv)

    network = XMemNet(load_model(args.model, device), args.compute_dtype,
                      device)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    total_seconds, total_frames = 0.0, 0
    with device_trace(args.profile_dir, device):
        for vid_reader in meta_dataset.get_datasets():
            seconds, frames = _eval_video(vid_reader, network, config, args,
                                          out_path, is_youtube, device)
            total_seconds += seconds
            total_frames += frames

    fps = total_frames / total_seconds if total_seconds > 0 else None
    print(f'Total processing time: {total_seconds}')
    print(f'Total processed frames: {total_frames}')
    if fps is not None:
        print(f'FPS: {fps}')
    peak_mb = None
    if device.type == 'cuda':
        peak_mb = torch.cuda.max_memory_allocated(device) / 2 ** 20
        print(f'Max allocated memory (MB): {peak_mb:.0f}')
    else:
        print('Max allocated memory (MB): n/a (not measured on the CPU)')

    # zip packaging for benchmark submission (reference eval.py:250-257)
    if not args.save_scores:
        if is_youtube:
            print('Making zip for YouTubeVOS...')
            shutil.make_archive(
                path.join(args.output, path.basename(args.output)),
                'zip', args.output, 'Annotations')
        elif is_davis and args.split == 'test':
            print('Making zip for DAVIS test-dev...')
            shutil.make_archive(args.output, 'zip', args.output)
    return {'seconds': total_seconds, 'frames': total_frames, 'fps': fps,
            'peak_memory_mb': peak_mb}


if __name__ == '__main__':
    main()
