"""GUI workspace on disk: frames, masks, visualizations, reference set, and
the per-frame key/shrinkage/selection/mask cache for the candidate selector.

Counterpart of xmem2_tpu/interactive/resource_manager.py (reference
inference/interact/resource_manager.py: ResourceManager :46, LRU :25,
add_key_and_stuff_with_mask :171, info.json persistence :206-223, frame
extraction/copy-resize :133-169). The key caches are tensors on the device
the keys come from (channels-last [N, h, w, C], as select_next_candidates
takes them); the small masks are host arrays. Frames are resized with
utils.resize_np.resize_area_np (cv2's INTER_AREA, within one step) and
written with PIL at cv2's default JPEG quality; only `video` input needs
cv2, imported there.
"""

import collections
import json
import os
import shutil
from os import path
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from xmem2_tpu_torch.utils.image_loader import PaletteConverter
from xmem2_tpu_torch.utils.palette import davis_palette
from xmem2_tpu_torch.utils.resize_np import resize_area_np

JPEG_QUALITY = 95        # cv2.imwrite's default


class LRU:
    """Buffered read with invalidation (reference resource_manager.py:25-43)."""

    def __init__(self, func, maxsize=128):
        self.cache = collections.OrderedDict()
        self.func = func
        self.maxsize = maxsize

    def __call__(self, *args):
        if args in self.cache:
            self.cache.move_to_end(args)
            return self.cache[args]
        result = self.func(*args)
        self.cache[args] = result
        if len(self.cache) > self.maxsize:
            self.cache.popitem(last=False)
        return result

    def invalidate(self, key):
        self.cache.pop(key, None)


class ResourceManager:
    def __init__(self, config):
        images = config.get('images')
        video = config.get('video')
        self.workspace = config.get('workspace')
        self.size = config['size']
        self.palette = davis_palette
        self.palette_converter = PaletteConverter(self.palette)

        if self.workspace is None:
            if images is not None:
                p_images = Path(images)
                if (p_images.name == 'JPEGImages'
                        or (Path.cwd() / 'workspace') in p_images.parents):
                    basename = p_images.parent.name
                else:
                    basename = p_images.name
            elif video is not None:
                basename = path.basename(video)[:-4]
            else:
                raise NotImplementedError(
                    'Either images, video, or workspace has to be specified')
            self.workspace = path.join('./workspace', basename)

        print(f'Workspace is in: {self.workspace}')
        self.workspace_info_file = path.join(self.workspace, 'info.json')
        self.references = set()
        self._num_objects = None
        self._try_load_info()

        if config.get('num_objects') is not None:
            self._num_objects = config['num_objects']
        elif self._num_objects is None:
            self._num_objects = config.get('num_objects_default_value', 1)
        self._save_info()

        need_decoding = need_resizing = False
        if path.exists(path.join(self.workspace, 'images')):
            pass
        elif images is not None:
            need_resizing = True
        elif video is not None:
            need_decoding = True

        self.image_dir = path.join(self.workspace, 'images')
        self.mask_dir = path.join(self.workspace, 'masks')
        os.makedirs(self.image_dir, exist_ok=True)
        os.makedirs(self.mask_dir, exist_ok=True)

        self.get_image = LRU(self._get_image_unbuffered,
                             maxsize=config.get('buffer_size', 100))
        self.get_mask = LRU(self._get_mask_unbuffered,
                            maxsize=config.get('buffer_size', 100))

        if need_decoding:
            self._extract_frames(video)
        if need_resizing:
            self._copy_resize_frames(images)

        self.names = sorted(f[:-4] for f in os.listdir(self.image_dir))
        self.length = len(self.names)
        assert self.length > 0, \
            f'No images found! Check {self.workspace}/images.'
        print(f'{self.length} images found.')

        self.height, self.width = self.get_image(0).shape[:2]
        self.visualization_init = False

        # key/shrinkage/selection/mask caches for the candidate selector
        self._masks = None
        self._keys = None
        self._shrinkages = None
        self._selections = None
        self._keys_processed = np.zeros(self.length, bool)
        self.key_h = self.key_w = None

    # -- ingest --------------------------------------------------------------
    def _extract_frames(self, video):
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(
                'reading a video file needs OpenCV (cv2), which is not '
                'installed: extract the frames to a folder and pass --images '
                'instead') from e
        cap = cv2.VideoCapture(video)
        frame_index = 0
        print(f'Extracting frames from {video} into {self.image_dir}...')
        while cap.isOpened():
            _, frame = cap.read()
            if frame is None:
                break
            frame = self._maybe_resize(frame)
            cv2.imwrite(path.join(self.image_dir,
                                  f'frame_{frame_index:06d}.jpg'), frame)
            frame_index += 1
        print('Done!')

    def _maybe_resize(self, frame: np.ndarray) -> np.ndarray:
        if self.size > 0:
            h, w = frame.shape[:2]
            new_w = (w * self.size // min(w, h))
            new_h = (h * self.size // min(w, h))
            if new_w != w or new_h != h:
                frame = resize_area_np(frame, (new_h, new_w))
        return frame

    def _copy_resize_frames(self, images):
        print(f'Copying/resizing frames into {self.image_dir}...')
        for image_name in sorted(os.listdir(images)):
            if self.size < 0:
                shutil.copy2(path.join(images, image_name), self.image_dir)
            else:
                with Image.open(path.join(images, image_name)) as im:
                    frame = np.asarray(im.convert('RGB'))
                Image.fromarray(self._maybe_resize(frame)).save(
                    path.join(self.image_dir, image_name),
                    quality=JPEG_QUALITY)
        print('Done!')

    # -- candidate-selector caches -------------------------------------------
    def add_key_and_stuff_with_mask(self, ti, key, shrinkage, selection, mask):
        """key/selection: [1, h, w, C] and shrinkage [1, h, w, 1] tensors
        (or arrays), kept on their device; mask [O, H', W'] (host array)."""
        key = torch.as_tensor(key)
        mask = np.asarray(mask)
        if self._keys is None:
            h, w, c = key.shape[1:]
            self.key_h, self.key_w = h, w
            dev = key.device
            self._keys = torch.empty((self.length, h, w, c), device=dev)
            self._shrinkages = torch.empty((self.length, h, w, 1), device=dev)
            self._selections = torch.empty((self.length, h, w, c), device=dev)
            self._masks = np.empty((self.length,) + mask.shape, np.float32)
        if not self._keys_processed[ti]:
            self._keys[ti] = key[0]
            self._shrinkages[ti] = torch.as_tensor(shrinkage)[0]
            self._selections[ti] = torch.as_tensor(selection)[0]
            self._keys_processed[ti] = True
        self._masks[ti] = mask

    def all_masks_present(self):
        return self._keys_processed.sum() == self.length

    # -- reference bookkeeping -----------------------------------------------
    def add_reference(self, frame_id: int):
        self.references.add(frame_id)
        self._save_info()

    def remove_reference(self, frame_id: int):
        self.references.remove(frame_id)
        self._save_info()

    def _save_info(self):
        Path(self.workspace_info_file).parent.mkdir(parents=True, exist_ok=True)
        with open(self.workspace_info_file, 'wt') as f:
            json.dump({'references': sorted(self.references),
                       'num_objects': self._num_objects}, f, indent=4)

    def _try_load_info(self):
        try:
            with open(self.workspace_info_file) as f:
                data = json.load(f)
            self._num_objects = data['num_objects']
            self.references = set(data['references'])
        except (OSError, ValueError, KeyError):
            pass      # no workspace yet, or an info.json of another layout

    # -- disk IO ---------------------------------------------------------------
    def save_mask(self, ti, mask: np.ndarray):
        assert 0 <= ti < self.length
        img = Image.fromarray(mask)
        img.putpalette(self.palette)
        img.save(path.join(self.mask_dir, self.names[ti] + '.png'))
        self.invalidate(ti)

    def save_visualization(self, ti, image: np.ndarray):
        assert 0 <= ti < self.length
        if not self.visualization_init:
            self.visualization_dir = path.join(self.workspace, 'visualization')
            os.makedirs(self.visualization_dir, exist_ok=True)
            self.visualization_init = True
        Image.fromarray(image).save(
            path.join(self.visualization_dir, self.names[ti] + '.jpg'))

    def _get_image_unbuffered(self, ti):
        assert 0 <= ti < self.length
        return np.array(Image.open(
            path.join(self.image_dir, self.names[ti] + '.jpg')))

    def _get_mask_unbuffered(self, ti):
        assert 0 <= ti < self.length
        mask_path = path.join(self.mask_dir, self.names[ti] + '.png')
        if path.exists(mask_path):
            return np.array(Image.open(mask_path))
        return None

    def read_external_image(self, file_name, size=None, force_mask=False):
        image = Image.open(file_name)
        is_mask = image.mode in ['L', 'P']
        if size is not None:
            image = image.resize(
                (size[1], size[0]),
                resample=Image.Resampling.NEAREST if is_mask or force_mask
                else Image.Resampling.BICUBIC)
        if force_mask and image.mode != 'P':
            image = self.palette_converter.image_to_index_mask(image)
        return np.array(image)

    def invalidate(self, ti):
        self.get_mask.invalidate((ti,))

    def __len__(self):
        return self.length

    @property
    def h(self):
        return self.height

    @property
    def w(self):
        return self.width

    @property
    def small_masks(self):
        return self._masks

    @property
    def keys(self):
        return self._keys

    @property
    def shrinkages(self):
        return self._shrinkages

    @property
    def selections(self):
        return self._selections

    @property
    def num_objects(self):
        return self._num_objects
