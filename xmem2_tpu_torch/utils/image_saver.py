"""Async mask/overlay writers + overlay composition (a copy of
xmem2_tpu/utils/image_saver.py without the training montage).

Behavioral parity target: reference util/image_saver.py (create_overlay :161,
save_image :181, ParallelImageSaver :189). PNG encoding and disk IO run in
background worker processes so they overlap with device compute; a `workers=0`
mode degrades to synchronous writes (useful on single-core test machines).
"""

import multiprocessing
import os
import time
from pathlib import Path
from typing import Tuple

import numpy as np
from PIL import Image

# 'spawn' children, not fork: the parent runs CUDA and thread pools, and a
# fork()ed child inherits their locked mutexes. Spawned workers start clean
# but re-import the caller's __main__ module, so entry points keep their work
# under the __main__ check. They also re-import this module, which therefore
# imports torch (through utils/profiling.py, for the spans) only inside the
# methods that the parent alone runs.
_MP = multiprocessing.get_context('spawn')


def _check_if_black_and_white(mask_rgb: Image.Image) -> bool:
    colors = mask_rgb.getcolors()
    if colors is None or len(colors) > 2:
        return False
    if len(colors) == 1:
        return True  # all-black image
    return any(rgb == (255, 255, 255) for _, rgb in colors)


def create_overlay(img: Image.Image, mask: Image.Image, mask_alpha=0.5,
                   color_if_black_and_white=(255, 255, 255)) -> Image.Image:
    """Alpha-composite the mask over the image; single-object black&white
    masks are recolored (reference image_saver.py:161-179)."""
    mask = mask.convert('RGB')
    is_bw = _check_if_black_and_white(mask)
    if img.size != mask.size:
        mask = mask.resize(img.size, resample=Image.NEAREST)

    mask_arr = np.array(mask)
    if is_bw:
        mask_arr = np.where(mask_arr, np.array(color_if_black_and_white),
                            mask_arr).astype(np.uint8)
        mask = Image.fromarray(mask_arr, mode='RGB')

    # 255 (keep image) on background, mask_alpha on predicted pixels
    gray = mask_arr @ np.array([0.114, 0.587, 0.299])  # BGR2GRAY on RGB data,
    # matching the reference's cv2.cvtColor(mask_arr, COLOR_BGR2GRAY) call
    alpha = np.full(mask_arr.shape[:2], 255, np.uint8)
    alpha[gray > 0.5] = int(mask_alpha * 255)
    return Image.composite(img, mask, Image.fromarray(alpha, mode='L'))


def save_image(img: Image.Image, frame_name, video_name, general_dir_path,
               sub_dir_name='masks', extension='.png'):
    out_dir = os.path.join(str(general_dir_path), str(video_name), sub_dir_name)
    os.makedirs(out_dir, exist_ok=True)
    img.save(os.path.join(out_dir, frame_name[:-4] + extension))


def _mask_worker(q, vid_name, out_path):
    # blocking get + None sentinel: the queue is FIFO, so every enqueued item
    # is saved before the shutdown sentinel is seen — no drain race against
    # the parent's feeder thread
    while True:
        item = q.get()
        if item is None:
            return
        mask, frame_name, subdir, ext = item
        save_image(mask, frame_name, vid_name, out_path, subdir, ext)


def _overlay_worker(q, vid_name, out_path, object_color):
    while True:
        item = q.get()
        if item is None:
            return
        orig, mask, frame_name, subdir, ext = item
        ov = create_overlay(orig, mask, color_if_black_and_white=object_color)
        save_image(ov, frame_name, vid_name, out_path, subdir, ext)


class ParallelImageSaver:
    """Background mask/overlay saving (reference image_saver.py:189-345).

    workers>0: one process per stream (mask, overlay). workers=0: synchronous.
    """

    def __init__(self, general_output_path: str, vid_name: str,
                 overlay_color_if_b_and_w=(255, 255, 255),
                 max_queue_size: int = 200, workers: int = 1):
        self._p_out = Path(general_output_path)
        self._vid_name = vid_name
        self._object_color = overlay_color_if_b_and_w
        self._workers = workers
        if workers > 0:
            self._mask_queue = _MP.Queue(max_queue_size)
            self._overlay_queue = _MP.Queue(max_queue_size)
        self._mask_proc = None
        self._overlay_proc = None
        self._closed = False

    def save_mask(self, mask: Image.Image, frame_name: str):
        if self._workers == 0:
            save_image(mask, frame_name, self._vid_name, self._p_out,
                       'masks', '.png')
            return
        self._mask_queue.put((mask, frame_name, 'masks', '.png'))
        if self._mask_proc is None:
            from xmem2_tpu_torch.utils.profiling import annotate
            with annotate('xmem.writers.start'):
                self._mask_proc = _MP.Process(
                    target=_mask_worker,
                    args=(self._mask_queue, self._vid_name, self._p_out),
                    daemon=True)
                self._mask_proc.start()

    def save_overlay(self, orig_img: Image.Image, mask: Image.Image,
                     frame_name: str):
        if self._workers == 0:
            ov = create_overlay(orig_img, mask,
                                color_if_black_and_white=self._object_color)
            save_image(ov, frame_name, self._vid_name, self._p_out,
                       'overlay', '.jpg')
            return
        self._overlay_queue.put((orig_img, mask, frame_name, 'overlay', '.jpg'))
        if self._overlay_proc is None:
            from xmem2_tpu_torch.utils.profiling import annotate
            with annotate('xmem.writers.start'):
                self._overlay_proc = _MP.Process(
                    target=_overlay_worker,
                    args=(self._overlay_queue, self._vid_name, self._p_out,
                          self._object_color), daemon=True)
                self._overlay_proc.start()

    def qsize(self) -> Tuple[int, int]:
        if self._workers == 0:
            return 0, 0
        return self._mask_queue.qsize(), self._overlay_queue.qsize()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, exc_tb):
        if exc_type is not None:
            self._teardown(kill=True)
            return False
        self.wait_for_jobs_to_finish(verbose=False)
        return False

    def _teardown(self, kill: bool):
        if self._workers == 0 or self._closed:
            return
        self._closed = True
        for p in (self._mask_proc, self._overlay_proc):
            if p is not None and kill and p.is_alive():
                p.kill()
        # drop any unflushed feeder-buffer data so interpreter shutdown never
        # blocks joining a feeder thread whose reader process is gone
        for q in (self._mask_queue, self._overlay_queue):
            q.cancel_join_thread()
            q.close()

    def wait_for_jobs_to_finish(self, verbose: bool = False):
        if self._workers == 0 or self._closed:
            return
        from xmem2_tpu_torch.utils.profiling import annotate
        with annotate('xmem.writers.drain'):
            for q, p in ((self._mask_queue, self._mask_proc),
                         (self._overlay_queue, self._overlay_proc)):
                if p is not None:
                    q.put(None)                      # shutdown sentinel
            if verbose:
                while True:
                    m, o = self.qsize()
                    if max(m, o) == 0:
                        break
                    print(f'Finishing saving the results, {m:>4d} masks and '
                          f'{o:>4d} overlays left.')
                    time.sleep(1)
            for p in (self._mask_proc, self._overlay_proc):
                if p is not None:
                    p.join()
            self._teardown(kill=False)
        if verbose:
            print('All saving jobs finished')
