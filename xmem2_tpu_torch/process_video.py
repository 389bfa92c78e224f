"""Process a video with the PyTorch/CUDA port:

    python -m xmem2_tpu_torch.process_video --video <frames dir> \
        --masks <masks dir> --output <dir> --model <ckpt.pth|.npz>

The flags of the root process_video.py (reference process_video.py:8-30):
frame numbers come from the mask file names and are the annotated frames.
Runs on CUDA; --device cpu runs on the CPU.
"""

import os
import re
import sys
from argparse import ArgumentParser


def main(argv=None) -> int:
    parser = ArgumentParser()
    parser.add_argument('--video', '-v', type=str, required=True,
                        help='Path to the video file or directory with .jpg '
                             'frames')
    parser.add_argument('--masks', '-m', type=str, required=True,
                        help='Path to the directory with individual .png '
                             'masks for corresponding video frames')
    parser.add_argument('--output', '-o', type=str, required=True,
                        help='Path to save the resulting masks and overlays')
    parser.add_argument('--model', type=str, default=None,
                        help='Optional model checkpoint override (.pth or '
                             '.npz)')
    parser.add_argument('--compute_dtype', type=str, default=None,
                        choices=['auto', 'float32', 'bfloat16'],
                        help="Optional compute dtype override ('auto' = "
                             "bfloat16 on CUDA, float32 on the CPU)")
    parser.add_argument('--exact', action='store_true',
                        help='force float32 compute + float32 memory value '
                             'stores')
    parser.add_argument('--size', type=int, default=None,
                        help='Resize shorter side to this (default 480; -1 '
                             'keeps original)')
    parser.add_argument('--device', type=str, default=None,
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    frames_with_masks = []
    for file_name in os.listdir(args.masks):
        if not file_name.lower().endswith('.png'):
            continue
        match = re.search(r'\d+', file_name)
        if match is None:
            print(f'ERROR: file {file_name} does not contain a frame number. '
                  f'Cannot load it as a mask.')
            return 1
        frames_with_masks.append(int(match.group()))
    print('Using masks for frames:', frames_with_masks)

    overwrite_config = {}
    if args.model is not None:
        overwrite_config['model'] = args.model
    if args.compute_dtype is not None:
        overwrite_config['compute_dtype'] = args.compute_dtype
    if args.exact:
        overwrite_config['compute_dtype'] = 'float32'
        overwrite_config['value_store_dtype'] = 'float32'
    if args.size is not None:
        overwrite_config['size'] = args.size

    from xmem2_tpu_torch.inference.run_on_video import run_on_video
    run_on_video(args.video, args.masks, args.output,
                 frames_with_masks=frames_with_masks, device=args.device,
                 overwrite_config=overwrite_config or None)
    return 0


if __name__ == '__main__':
    sys.exit(main())
