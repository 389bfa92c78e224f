"""Static-image pretraining dataset: pseudo-video via random warps.

Copy of xmem2_tpu/train/static_dataset.py (reference
dataset/static_dataset.py:16-179): per-frame affine/TPS warps of a still
image + mask, multi-object samples by compositing several images. The same
seed and files give byte-equal samples.

Emits channels-last numpy like VOSDataset.
"""

import os
from os import path

import numpy as np
from PIL import Image

from xmem2_tpu_torch.train import augs as A


class StaticTransformDataset:
    """parameters: list of (root, method, multiplier); method 0 = FSS layout
    (class/1.jpg class/1.png), method 1 = flat (XXX.jpg XXX.png)."""

    def __init__(self, parameters, num_frames=3, max_num_obj=1, seed=None,
                 crop_size=384):
        self.num_frames = num_frames
        self.max_num_obj = max_num_obj
        self.crop_size = crop_size   # reference hardcodes 384
        self.rng = np.random.default_rng(seed)

        self.im_list = []
        for root, method, multiplier in parameters:
            if method == 0:
                for c in os.listdir(root):
                    imgs = os.listdir(path.join(root, c))
                    jpgs = [im for im in imgs if im[-3:].lower() == 'jpg']
                    self.im_list.extend(
                        [path.join(root, c, im) for im in jpgs] * multiplier)
            elif method == 1:
                self.im_list.extend(
                    [path.join(root, im) for im in os.listdir(root)
                     if '.jpg' in im] * multiplier)
        print(f'{len(self.im_list)} images found.')

    def __len__(self):
        return len(self.im_list)

    def _get_sample(self, idx):
        rng = self.rng
        im = Image.open(self.im_list[idx]).convert('RGB')
        gt = Image.open(self.im_list[idx][:-3] + 'png').convert('L')

        # sequence-level params (same for all pseudo-frames)
        seq_aff = A.sample_affine(rng, degrees=0, scale=(0.8, 1.5))
        seq_flip = A.sample_hflip(rng)
        seq_jitter = A.sample_color_jitter(rng, 0.1, 0.05, 0.05, 0.05)
        seq_gray = A.maybe_grayscale(rng, 0.05)

        images, masks = [], []
        for _ in range(self.num_frames):
            ti = A.apply_affine(im, seq_aff, 'bilinear', fill=A.IM_MEAN)
            tg = A.apply_affine(gt, seq_aff, 'nearest', fill=0)
            if seq_flip:
                ti, tg = A.apply_hflip(ti), A.apply_hflip(tg)
            ti = A.apply_color_jitter(ti, seq_jitter)
            if seq_gray:
                ti = A.apply_grayscale(ti)

            # pair-level: affine + resize + random crop (reference :51-61,
            # 384 there; crop_size here)
            cs = self.crop_size
            aff = A.sample_affine(rng, degrees=20, scale=(0.9, 1.1), shear=10)
            ti = A.apply_affine(ti, aff, 'bicubic', fill=A.IM_MEAN)
            tg = A.apply_affine(tg, aff, 'nearest', fill=0)
            ti = A.resize_shorter(ti, cs, 'bicubic')
            tg = A.resize_shorter(tg, cs, 'nearest')
            crop = A.sample_crop(rng, ti.size, (cs, cs))
            ti = A.apply_crop(ti, crop, (cs, cs), fill=A.IM_MEAN)
            tg = A.apply_crop(tg, crop, (cs, cs), fill=0)
            ti = A.apply_color_jitter(
                ti, A.sample_color_jitter(rng, 0.1, 0.05, 0.05, 0))

            if rng.random() < 0.33:
                ti, tg = A.random_tps_warp(ti, tg, rng, scale=0.02)

            images.append(A.to_normalized_array(ti))
            masks.append(np.asarray(tg, np.float32) / 255.0)

        return np.stack(images, 0), np.stack(masks, 0)  # [T,H,W,3], [T,H,W]

    def __getitem__(self, idx):
        rng = self.rng
        additional_objects = int(rng.integers(self.max_num_obj))
        indices = [idx] + list(rng.integers(len(self), size=additional_objects))

        merged_images = None
        cs = self.crop_size
        merged_masks = np.zeros((self.num_frames, cs, cs), np.int32)
        for i, list_id in enumerate(indices):
            images, masks = self._get_sample(int(list_id))
            m = masks[..., None]
            if merged_images is None:
                merged_images = images
            else:
                merged_images = merged_images * (1 - m) + images * m
            merged_masks[masks > 0.5] = i + 1

        labels = np.unique(merged_masks[0])
        labels = labels[labels != 0]
        target_objects = labels.tolist()

        cls_gt = np.zeros((self.num_frames, cs, cs), np.int32)
        first_frame_gt = np.zeros((1, self.max_num_obj, cs, cs), np.float32)
        for i, l in enumerate(target_objects):
            this_mask = merged_masks == l
            cls_gt[this_mask] = i + 1
            first_frame_gt[0, i] = this_mask[0]

        num_objects = max(1, len(target_objects))
        selector = np.array(
            [1 if i < num_objects else 0 for i in range(self.max_num_obj)],
            np.float32)

        return {
            'rgb': merged_images.astype(np.float32),
            'first_frame_gt': first_frame_gt,
            'cls_gt': cls_gt,
            'selector': selector,
            'info': {'name': self.im_list[idx], 'num_objects': num_objects},
        }
