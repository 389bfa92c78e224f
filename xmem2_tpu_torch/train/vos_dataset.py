"""VOS training dataset: temporal frame sampling + paired augmentations.

Copy of xmem2_tpu/train/vos_dataset.py (reference dataset/vos_dataset.py
:15-216): bounded-jump iterative frame sampling, 50% time reversal,
sequence-level and pair-level augmentations identical for image/mask
(bilinear vs nearest), max 3 target objects, 384x384 crops, BL30K
pixel-count label filtering. The same seed and files give byte-equal
samples.

Emits channels-last numpy: rgb [T, H, W, 3] f32, first_frame_gt [1, O, H, W],
cls_gt [T, H, W] int32, selector [O].
"""

import os
from os import path
from typing import Optional

import numpy as np
from PIL import Image

from xmem2_tpu_torch.train import augs as A


class VOSDataset:
    def __init__(self, im_root, gt_root, max_jump, is_bl, subset=None,
                 num_frames=3, max_num_obj=3, finetune=False, seed=None,
                 crop_size=384):
        self.crop_size = crop_size   # reference hardcodes 384
        self.im_root = im_root
        self.gt_root = gt_root
        self.max_jump = max_jump
        self.is_bl = is_bl
        self.num_frames = num_frames
        self.max_num_obj = max_num_obj
        self.finetune = finetune
        self.rng = np.random.default_rng(seed)

        self.videos = []
        self.frames = {}
        vid_list = sorted(os.listdir(self.im_root))
        for vid in vid_list:
            if subset is not None and vid not in subset:
                continue
            frames = sorted(os.listdir(path.join(self.im_root, vid)))
            if len(frames) < num_frames:
                continue
            self.frames[vid] = frames
            self.videos.append(vid)
        print(f'{len(self.videos)} out of {len(vid_list)} videos accepted in {im_root}.')

        self.crop_scale = (0.25, 1.0) if is_bl else (0.36, 1.0)
        no_geo = finetune or is_bl
        self.pair_degrees = 0 if no_geo else 15
        self.pair_shear = 0 if no_geo else 10

    def __len__(self):
        return len(self.videos)

    def _augment_frame(self, im: Image.Image, gt: Image.Image, seq, rng):
        """Apply sequence-level then pair-level augs, geometry shared between
        im and gt (reference vos_dataset.py:137-153)."""
        # sequence-level (same params every frame of the sequence)
        if seq['hflip']:
            im, gt = A.apply_hflip(im), A.apply_hflip(gt)
        crop = A.sample_resized_crop(rng, im.size, scale=self.crop_scale)
        cs = self.crop_size
        im = A.apply_resized_crop(im, crop, (cs, cs), 'bilinear')
        gt = A.apply_resized_crop(gt, crop, (cs, cs), 'nearest')
        im = A.apply_color_jitter(im, seq['jitter'])
        if seq['gray']:
            im = A.apply_grayscale(im)
        # pair-level (fresh params per frame)
        aff = A.sample_affine(rng, degrees=self.pair_degrees,
                              shear=self.pair_shear)
        im = A.apply_affine(im, aff, 'bilinear', fill=A.IM_MEAN)
        gt = A.apply_affine(gt, aff, 'nearest', fill=0)
        pj = A.sample_color_jitter(rng, 0.01, 0.01, 0.01, 0)
        im = A.apply_color_jitter(im, pj)
        return im, gt

    def __getitem__(self, idx):
        rng = self.rng
        video = self.videos[idx]
        info = {'name': video}
        vid_im_path = path.join(self.im_root, video)
        vid_gt_path = path.join(self.gt_root, video)
        frames = self.frames[video]

        trials = 0
        target_objects = []
        while trials < 5:
            info['frames'] = []
            length = len(frames)
            this_max_jump = min(length, self.max_jump)

            # iterative bounded-jump sampling (reference :114-123)
            frames_idx = [int(rng.integers(length))]
            acceptable = set(range(max(0, frames_idx[-1] - this_max_jump),
                                   min(length, frames_idx[-1] + this_max_jump + 1))
                             ).difference(frames_idx)
            while len(frames_idx) < self.num_frames:
                new_idx = int(rng.choice(sorted(acceptable)))
                frames_idx.append(new_idx)
                grow = set(range(max(0, new_idx - this_max_jump),
                                 min(length, new_idx + this_max_jump + 1)))
                acceptable = acceptable.union(grow).difference(frames_idx)

            frames_idx = sorted(frames_idx)
            if rng.random() < 0.5:
                frames_idx = frames_idx[::-1]  # reverse time

            seq = {
                'hflip': A.sample_hflip(rng),
                'jitter': A.sample_color_jitter(rng, 0.1, 0.03, 0.03, 0),
                'gray': A.maybe_grayscale(rng, 0.05),
            }

            images, masks = [], []
            for f_idx in frames_idx:
                jpg_name = frames[f_idx][:-4] + '.jpg'
                png_name = frames[f_idx][:-4] + '.png'
                info['frames'].append(jpg_name)
                im = Image.open(path.join(vid_im_path, jpg_name)).convert('RGB')
                gt = Image.open(path.join(vid_gt_path, png_name)).convert('P')
                im, gt = self._augment_frame(im, gt, seq, rng)
                images.append(A.to_normalized_array(im))
                masks.append(np.array(gt))

            labels = np.unique(masks[0])
            labels = labels[labels != 0]

            if self.is_bl:
                # pixel-count filtering for blender data (reference :164-176)
                good = []
                for l in labels:
                    pixel_sum = (masks[0] == l).sum()
                    if pixel_sum > 10 * 10:
                        if pixel_sum > 30 * 30:
                            good.append(l)
                        elif max((masks[1] == l).sum(),
                                 (masks[2] == l).sum()) < 20 * 20:
                            good.append(l)
                labels = np.array(good, np.uint8)

            if len(labels) == 0:
                trials += 1
            else:
                target_objects = labels.tolist()
                break

        if len(target_objects) > self.max_num_obj:
            target_objects = rng.choice(target_objects, size=self.max_num_obj,
                                        replace=False)
        info['num_objects'] = max(1, len(target_objects))

        masks = np.stack(masks, 0)
        cs = self.crop_size
        cls_gt = np.zeros((self.num_frames, cs, cs), np.int32)
        first_frame_gt = np.zeros((1, self.max_num_obj, cs, cs), np.float32)
        for i, l in enumerate(target_objects):
            this_mask = masks == l
            cls_gt[this_mask] = i + 1
            first_frame_gt[0, i] = this_mask[0]

        selector = np.array(
            [1 if i < info['num_objects'] else 0
             for i in range(self.max_num_obj)], np.float32)

        return {
            'rgb': np.stack(images, 0),
            'first_frame_gt': first_frame_gt,
            'cls_gt': cls_gt,
            'selector': selector,
            'info': info,
        }
