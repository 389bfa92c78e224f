"""Host-side (numpy) resize with exact torch semantics.

The reference resizes inputs on the CPU dataloader side with
torchvision.transforms.Resize(size, BILINEAR) applied to tensors — plain
bilinear, half-pixel centers, NO antialiasing (torchvision 0.13 default,
reference inference/data/video_reader.py:61-65) — and masks with
F.interpolate(mode='nearest') (video_reader.py:149-154). These helpers
reproduce both without a torch dependency.
"""

from typing import Tuple

import numpy as np


def shorter_side_size(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision Resize(int) convention: shorter side -> size, aspect kept
    (int truncation as in torchvision/functional)."""
    if h <= w:
        return size, max(1, int(size * w / h))
    return max(1, int(size * h / w)), size


def resize_bilinear_np(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """img [H, W, C] float -> [oh, ow, C]; torch bilinear align_corners=False,
    no antialias."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img

    def axis(in_size, out_size):
        coord = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
        coord = np.clip(coord, 0.0, in_size - 1)
        lo = np.floor(coord).astype(np.int64)
        hi = np.minimum(lo + 1, in_size - 1)
        return lo, hi, (coord - lo).astype(np.float32)

    hlo, hhi, hf = axis(h, oh)
    wlo, whi, wf = axis(w, ow)
    x = img.astype(np.float32)
    top = x[hlo]
    bot = x[hhi]
    rows = top + (bot - top) * hf[:, None, None]
    left = rows[:, wlo]
    right = rows[:, whi]
    return left + (right - left) * wf[None, :, None]


def resize_nearest_np(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """torch F.interpolate(mode='nearest'): src = floor(dst * in/out).
    img [..., H, W] (trailing spatial)."""
    h, w = img.shape[-2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img
    hi = np.floor(np.arange(oh) * (h / oh)).astype(np.int64)
    wi = np.floor(np.arange(ow) * (w / ow)).astype(np.int64)
    return img[..., hi, :][..., wi]


def _area_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of cv2's INTER_AREA along one axis: on a
    downscale, the share of each source pixel inside the output cell
    [d * s, (d + 1) * s), s = in / out; on an upscale, cv2's linear weights
    for INTER_AREA (the offset fx = (d + 1) - (floor(d * s) + 1) / s, taken
    modulo 1 and 0 where negative)."""
    scale = in_size / out_size
    wts = np.zeros((out_size, in_size), np.float64)
    if scale >= 1:
        for d in range(out_size):
            lo, hi = d * scale, min((d + 1) * scale, in_size)
            for s in range(int(np.floor(lo)), int(np.ceil(hi))):
                wts[d, s] = min(hi, s + 1) - max(lo, s)
            wts[d] /= hi - lo
        return wts
    inv = out_size / in_size
    for d in range(out_size):
        s = int(np.floor(d * scale))
        fx = (d + 1) - (s + 1) * inv
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        if s >= in_size - 1:
            s, fx = in_size - 1, 0.0
        wts[d, s] += 1 - fx
        if fx:
            wts[d, s + 1] += fx
    return wts


def resize_area_np(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA) for uint8
    [H, W] or [H, W, C] images, as a separable filter in float64 rounded half
    up: within one step of cv2's result (cv2 sums in other orders and
    precisions, in fixed point on an upscale)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img
    wy, wx = _area_weights(h, oh), _area_weights(w, ow)
    x = img.astype(np.float64)
    out = np.einsum('oh,hw...->ow...', wy, x)
    out = np.einsum('pw,ow...->op...', wx, out)
    return np.clip(np.floor(out + 0.5), 0, 255).astype(img.dtype)
