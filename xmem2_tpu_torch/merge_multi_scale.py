"""Multi-scale / flip ensemble merging, run as

    python -m xmem2_tpu_torch.merge_multi_scale --dataset D \
        --list <run> [<run> ...] --output <dir> [--num_proc 4]

Counterpart of the root merge_multi_scale.py (reference
merge_multi_scale.py:26-135). Host only: for every video under each run's
Scores/ (`python -m xmem2_tpu_torch.eval --save_scores` writes
Scores/<video>/<frame>.npz and backward.json), sums each frame's `prob` over
the runs that have it, takes the argmax, maps the indices back to the
original labels through backward.json, saves palette PNGs in the DAVIS
(<output>/<video>/) or YouTube-VOS (<output>/Annotations/<video>/) layout
and zips them for submission. Videos are merged in a multiprocessing Pool.
"""

import glob
import json
import os
import shutil
from argparse import ArgumentParser
from collections import defaultdict
from functools import partial
from multiprocessing import Pool
from os import path

import numpy as np
from PIL import Image

from xmem2_tpu_torch.utils.palette import davis_palette, youtube_palette


def search_options(options, name):
    for option in options:
        if path.exists(path.join(option, name)):
            return path.join(option, name)
    return None


def process_vid(vid, all_options, out_path, dataset, palette_bytes):
    vid_path = search_options(all_options, vid)
    backward_mapping = None
    if vid_path is not None:
        bpath = path.join(vid_path, 'backward.json')
        if path.exists(bpath):
            with open(bpath) as f:
                backward_mapping = {int(k): int(v)
                                    for k, v in json.load(f).items()}

    frames = [f for f in os.listdir(path.join(all_options[0], vid))
              if 'backward' not in f]

    if 'Y' in dataset:
        this_out_path = path.join(out_path, 'Annotations', vid)
    else:
        this_out_path = path.join(out_path, vid)
    os.makedirs(this_out_path, exist_ok=True)

    for f in frames:
        result_sum = None
        for option in all_options:
            p = path.join(option, vid, f)
            if not path.exists(p):
                continue
            with np.load(p) as z:
                result = z['prob'].astype(np.float32)
            result_sum = result if result_sum is None else result_sum + result

        result_sum = np.argmax(result_sum, axis=0)

        if backward_mapping is not None:
            idx_mask = np.zeros_like(result_sum, np.uint8)
            for label, i in backward_mapping.items():
                idx_mask[result_sum == i] = label
        else:
            idx_mask = result_sum.astype(np.uint8)

        img = Image.fromarray(idx_mask)
        img.putpalette(palette_bytes)
        img.save(path.join(this_out_path, f[:-4] + '.png'))


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument('--dataset', default='Y',
                        help='D/Y, D for DAVIS; Y for YouTubeVOS')
    parser.add_argument('--list', nargs='+')
    parser.add_argument('--pattern', default=None,
                        help='Glob pattern, used in place of --list')
    parser.add_argument('--output')
    parser.add_argument('--num_proc', default=4, type=int)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out_path = args.output
    if args.pattern is None:
        all_options = args.list
    else:
        if args.list is not None:
            raise ValueError('cannot specify both --list and --pattern')
        all_options = glob.glob(args.pattern)

    palette_bytes = davis_palette if 'D' in args.dataset else youtube_palette

    all_options = [path.join(o, 'Scores') for o in all_options]
    vid_count = defaultdict(int)
    for option in all_options:
        for vid in sorted(os.listdir(option)):
            vid_count[vid] += 1

    count_to_vid = defaultdict(int)
    for v in vid_count.values():
        count_to_vid[v] += 1
    for k, v in count_to_vid.items():
        print(f'Videos with count {k}: {v}')

    all_vid = sorted(vid_count)
    print('Total number of videos:', len(all_vid))

    work = partial(process_vid, all_options=all_options, out_path=out_path,
                   dataset=args.dataset, palette_bytes=palette_bytes)
    with Pool(processes=args.num_proc) as pool:
        for _ in pool.imap_unordered(work, all_vid):
            pass

    if 'D' in args.dataset:
        print('Making zip for DAVIS test-dev...')
        shutil.make_archive(args.output, 'zip', args.output)
    if 'Y' in args.dataset:
        print('Making zip for YouTubeVOS...')
        shutil.make_archive(path.join(args.output, path.basename(args.output)),
                            'zip', args.output, 'Annotations')


if __name__ == '__main__':
    main()
