"""VideoReader — streams frames (image dir or video file) with ImageNet
normalization, shorter-side resize, and palette-mask loading.

Behavioral parity target: reference inference/data/video_reader.py:32-165.
A copy of xmem2_tpu/inference/data/video_reader.py. Images via PIL, resize
via utils/resize_np (exact torch
bilinear/nearest semantics), optional cv2 for video-file frame extraction.
A tiny background prefetch thread replaces the torch DataLoader worker.
"""

import os
import queue
import threading
from dataclasses import dataclass
from os import path
from tempfile import TemporaryDirectory
from typing import Optional

import numpy as np
from PIL import Image

from xmem2_tpu_torch.utils.resize_np import (
    resize_bilinear_np, resize_nearest_np, shorter_side_size,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass
class Sample:
    rgb: np.ndarray                 # [H, W, 3] float32, normalized (+resized)
    raw_image_pil: Image.Image
    frame: str
    save: bool
    shape: tuple                    # original (H, W)
    need_resize: bool
    mask: Optional[np.ndarray] = None  # [H, W] uint8 index mask (original size)
    rgb_u8: Optional[np.ndarray] = None  # [H0, W0, 3] raw uint8 (device-preprocess path)


class VideoReader:
    """Reads a video one frame at a time (reference video_reader.py:32)."""

    def __init__(self, vid_name, video_path, mask_dir, size=-1, to_save=None,
                 use_all_masks=False, size_dir=None, host_preprocess=True):
        """host_preprocess=False skips CPU-side normalize/resize: Sample.rgb
        is None and Sample.rgb_u8 carries the raw frame for the on-device
        preprocessing path (inference/preprocess.py)."""
        self.vid_name = vid_name
        self.video_path = video_path
        self.mask_dir = mask_dir
        self.to_save = to_save
        self.use_all_masks = use_all_masks
        self.size = size
        self.host_preprocess = host_preprocess

        mask_files = sorted(os.listdir(mask_dir))
        if not mask_files:
            raise FileNotFoundError(f'no masks in {mask_dir}')
        self.reference_mask = Image.open(
            path.join(mask_dir, mask_files[0])).convert('P')
        self.first_gt_path = path.join(mask_dir, mask_files[0])

        if os.path.isfile(video_path):
            self.tmp_dir = TemporaryDirectory()
            self.image_dir = self.tmp_dir.name
            self._extract_frames()
        else:
            self.image_dir = video_path

        self.size_dir = self.image_dir if size_dir is None else size_dir
        self.frames = sorted(os.listdir(self.image_dir))

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx) -> Sample:
        frame_name = self.frames[idx]
        im_path = path.join(self.image_dir, frame_name)
        img_pil = Image.open(im_path).convert('RGB')

        if self.image_dir == self.size_dir:
            shape = (img_pil.height, img_pil.width)
        else:
            with Image.open(path.join(self.size_dir, frame_name)) as size_im:
                shape = (size_im.height, size_im.width)

        gt_path = path.join(self.mask_dir, frame_name[:-4] + '.png')
        if not os.path.exists(gt_path):
            gt_path = path.join(self.mask_dir, frame_name[:-4] + '.PNG')

        rgb_u8 = np.asarray(img_pil, np.uint8)
        if self.host_preprocess:
            rgb = rgb_u8.astype(np.float32) / 255.0
            rgb = (rgb - IMAGENET_MEAN) / IMAGENET_STD
            if self.size > 0:
                rgb = resize_bilinear_np(
                    rgb, shorter_side_size(rgb.shape[0], rgb.shape[1], self.size))
        else:
            rgb = None

        mask = None
        load_mask = self.use_all_masks or (gt_path == self.first_gt_path)
        if load_mask and path.exists(gt_path):
            mask = np.array(Image.open(gt_path).convert('P'), np.uint8)

        return Sample(
            rgb=rgb,
            raw_image_pil=img_pil,
            frame=frame_name,
            save=(self.to_save is None) or (frame_name[:-4] in self.to_save),
            shape=shape,
            need_resize=self.size > 0,
            mask=mask,
            rgb_u8=rgb_u8,
        )

    def __iter__(self):
        """Background-prefetched iteration (replaces the reference's
        DataLoader(num_workers=1), run_on_video.py:186): decode/resize of
        frame i+1 overlaps with device compute on frame i."""
        q: 'queue.Queue' = queue.Queue(maxsize=4)
        stop = object()

        def worker():
            try:
                for i in range(len(self)):
                    q.put(self[i])
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item

    def __del__(self):
        if hasattr(self, 'tmp_dir'):
            self.tmp_dir.cleanup()

    def _extract_frames(self):
        import cv2
        cap = cv2.VideoCapture(self.video_path)
        frame_index = 0
        print(f'Extracting frames from {self.video_path} into a temporary dir...')
        while cap.isOpened():
            _, frame = cap.read()
            if frame is None:
                break
            if self.size > 0:
                h, w = frame.shape[:2]
                new_w = (w * self.size // min(w, h))
                new_h = (h * self.size // min(w, h))
                if new_w != w or new_h != h:
                    frame = cv2.resize(frame, dsize=(new_w, new_h),
                                       interpolation=cv2.INTER_AREA)
            cv2.imwrite(path.join(self.image_dir,
                                  f'frame_{frame_index:06d}.jpg'), frame)
            frame_index += 1
        print('Done!')

    def im_transform(self, img_pil: Image.Image) -> np.ndarray:
        """Raw PIL -> normalized (+resized) [H, W, 3] float32 array — the same
        transform __getitem__ applies (reference video_reader.py:56-65)."""
        rgb = np.asarray(img_pil.convert('RGB'), np.float32) / 255.0
        rgb = (rgb - IMAGENET_MEAN) / IMAGENET_STD
        if self.size > 0:
            rgb = resize_bilinear_np(
                rgb, shorter_side_size(rgb.shape[0], rgb.shape[1], self.size))
        return rgb

    def resize_mask(self, mask: np.ndarray) -> np.ndarray:
        """mask [..., H, W] -> nearest-resized so min side == self.size
        (reference video_reader.py:149-154)."""
        h, w = mask.shape[-2:]
        min_hw = min(h, w)
        return resize_nearest_np(
            mask, (int(h / min_hw * self.size), int(w / min_hw * self.size)))

    def get_palette(self):
        """Palette of the first GT mask (fixes the reference's latent
        eval.py:233 AttributeError — VideoReader.get_palette did not exist)."""
        return self.reference_mask.getpalette()

    def map_the_colors_back(self, pred_mask: Image.Image) -> Image.Image:
        """Map a grayscale index mask back to the annotation palette
        (reference video_reader.py:156-159: PIL quantize, no dithering)."""
        return pred_mask.quantize(
            palette=self.reference_mask, dither=Image.Dither.NONE).convert('RGB')
