"""Compare annotation-frame selection strategies by the IoU and J&F they
reach, with the PyTorch/CUDA port:

    python -m xmem2_tpu_torch.run_experiments --videos_root <dir> \
        --output <dir> --model <ckpt.pth|.npz>

Counterpart of the root run_experiments.py (reference
inference/run_experiments.py, whose own version imports a removed
`predict_annotation_candidates`, run_experiments.py:18). Selectors:
first_frame_only, uniform and cycle_dissimilarity (frame 0, then the k - 1
frames select_k_next_best_annotation_candidates picks from the masks frame
0 alone propagates). Each video is <root>/<video>/{JPEGImages,Annotations}/.
Runs on CUDA unless --device cpu is given.
"""

import json
import os
from argparse import ArgumentParser
from os import path
from pathlib import Path

import numpy as np
from PIL import Image

from xmem2_tpu_torch.inference.frame_selection.frame_selection import \
    uniformly_selected_frames


def _rows(stats):
    """run_on_video's rows as a list of dicts (it returns a DataFrame where
    pandas is installed)."""
    return stats.to_dict('records') if hasattr(stats, 'to_dict') else stats


def run_one_video(video_dir, out_root, k, selectors, overwrite_config=None,
                  device=None):
    """Each selector's frames, annotated, propagated with IoU against the
    video's own masks. Returns {selector: {'frames', 'mean_iou'}}; the mean
    covers the frames the model did not see annotated."""
    from xmem2_tpu_torch.inference.run_on_video import (
        run_on_video, select_k_next_best_annotation_candidates)

    video_dir = Path(video_dir)
    imgs = video_dir / 'JPEGImages'
    masks = video_dir / 'Annotations'
    n_frames = len(list(imgs.iterdir()))
    results = {}
    for selector in selectors:
        out_dir = Path(out_root) / selector / video_dir.name
        if selector == 'first_frame_only':
            frames = [0]
        elif selector == 'uniform':
            frames = uniformly_selected_frames(n_frames, k)
        elif selector == 'cycle_dissimilarity':
            baseline_out = Path(out_root) / '_baseline' / video_dir.name
            run_on_video(imgs, masks, baseline_out, frames_with_masks=[0],
                         print_progress=False, device=device,
                         overwrite_config=overwrite_config)
            extra = select_k_next_best_annotation_candidates(
                imgs, masks, baseline_out, k=k - 1,
                previously_chosen_candidates=[0],
                use_previously_predicted_masks=True, print_progress=False,
                device=device, overwrite_config=overwrite_config)
            frames = sorted([0] + list(extra))
        else:
            raise ValueError(selector)

        stats = run_on_video(imgs, masks, out_dir, frames_with_masks=frames,
                             compute_iou=True, print_progress=False,
                             device=device, overwrite_config=overwrite_config)
        ious = [r['iou'] for r in _rows(stats) if r['iou'] >= 0]
        results[selector] = {
            'frames': [int(f) for f in frames],
            'mean_iou': float(np.mean(ious)) if ious else float('nan'),
        }
        print(f'{video_dir.name} / {selector}: frames={frames} '
              f'mean IoU={results[selector]["mean_iou"]:.4f}')
    return results


def compute_metrics(pred_root, gt_root):
    """DAVIS J&F over saved predictions (reference compute_metrics :376).

    Predictions are saved as RGB (palette colours mapped back), so they are
    quantised against the ground truth's own palette to recover object
    indices (reference _load_preds, run_experiments.py:322-323); a plain
    convert('P') would invent an adaptive palette whose indices never match
    the ground truth's."""
    from xmem2_tpu_torch.utils.metrics import batched_f_measure, \
        batched_jaccard
    rows = {}
    for vid in sorted(os.listdir(pred_root)):
        pred_dir = path.join(pred_root, vid, 'masks')
        gt_dir = path.join(gt_root, vid)
        if not path.isdir(pred_dir):
            continue
        preds, gts = [], []
        palette_img = None
        for f in sorted(os.listdir(pred_dir)):
            gt_path = path.join(gt_dir, f)
            if not path.exists(gt_path):
                continue
            gt_img = Image.open(gt_path).convert('P')
            if palette_img is None:
                palette_img = gt_img
            gts.append(np.array(gt_img))
            pred_img = Image.open(path.join(pred_dir, f))
            if pred_img.mode == 'P':
                preds.append(np.array(pred_img))
            else:
                preds.append(np.array(
                    pred_img.convert('RGB').quantize(
                        palette=palette_img, dither=Image.Dither.NONE)))
        if not preds:
            continue
        y_pred, y_true = np.stack(preds), np.stack(gts)
        j = batched_jaccard(y_true, y_pred).mean()
        f = batched_f_measure(y_true, y_pred).mean()
        rows[vid] = {'J': float(j), 'F': float(f), 'J&F': float((j + f) / 2)}
        print(f'{vid}: J={j:.4f} F={f:.4f}')
    return rows


def main(argv=None) -> dict:
    parser = ArgumentParser()
    parser.add_argument('--videos_root', required=True,
                        help='Directory of videos, each with JPEGImages/ and '
                             'Annotations/')
    parser.add_argument('--output', required=True)
    parser.add_argument('--k', type=int, default=5,
                        help='Annotated frames per video')
    parser.add_argument('--selectors', nargs='+',
                        default=['first_frame_only', 'uniform',
                                 'cycle_dissimilarity'])
    parser.add_argument('--model', default=None)
    parser.add_argument('--size', type=int, default=None)
    parser.add_argument('--device', default=None,
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    overwrite = {}
    if args.model:
        overwrite['model'] = args.model
    if args.size is not None:
        overwrite['size'] = args.size

    all_results = {}
    for vid in sorted(os.listdir(args.videos_root)):
        vd = path.join(args.videos_root, vid)
        if not path.isdir(vd):
            continue
        try:
            all_results[vid] = run_one_video(
                vd, args.output, args.k, args.selectors,
                overwrite_config=overwrite or None, device=args.device)
        except Exception as e:  # one video's failure (reference :167-177)
            print(f'{vid} failed ({e!r}); falling back to uniform only')
            all_results[vid] = run_one_video(
                vd, args.output, args.k, ['uniform'],
                overwrite_config=overwrite or None, device=args.device)

    os.makedirs(args.output, exist_ok=True)
    with open(path.join(args.output, 'results.json'), 'wt') as f:
        json.dump(all_results, f, indent=2)
    print(json.dumps(all_results, indent=2))
    return all_results


if __name__ == '__main__':
    main()
