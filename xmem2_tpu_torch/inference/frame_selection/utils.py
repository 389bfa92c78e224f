"""Frame-selection utilities: per-frame key extraction and the deterministic
augmentation catalog for permanent-memory augmentation.

Counterpart of xmem2_tpu/inference/frame_selection/utils.py (reference
inference/frame_selection/frame_selection_utils.py: extract_keys :11,
get_determenistic_augmentations :50). The augmentation catalog is a copy:
pure PIL/numpy, byte-identical outputs. It reproduces torchvision semantics
without the dependency: image affines use the PIL path with torchvision's
inverse matrix and NEAREST default; mask affines replicate the tensor path
exactly (half-pixel grid + nearest round); gaussian blur is torchvision's
truncated FIR kernel (sigma 1.4, reflect pad), not PIL's IIR
approximation. Parameters: rotate ±30°, shear ±20°, zoom 0.5x/1.5x,
brightness 1.5x/0.5x, posterize 3 bits, sharpness 16x, blur k=7.

extract_keys departs from the JAX package in where its result lives: the
keys stay on the device, stacked, instead of being copied to the host frame
by frame.
"""

from typing import Callable, List, Tuple

import numpy as np
import torch
from PIL import Image, ImageEnhance, ImageOps


@torch.no_grad()
def extract_keys(vid_reader, processor, print_progress=False):
    """One pass over the video computing key, shrinkage and selection per
    frame with processor.encode_frame_key.

    Returns (keys [N, Ck, h, w], shrinkages [N, 1, h, w], selections
    [N, Ck, h, w]), float32 tensors on the processor's device."""
    keys, shrinkages, selections = [], [], []
    for i, sample in enumerate(vid_reader):
        key, shrinkage, selection = processor.encode_frame_key(
            sample.rgb if sample.rgb is not None else sample.rgb_u8)
        keys.append(key[0])
        shrinkages.append(shrinkage[0])
        selections.append(selection[0])
        if print_progress and (i + 1) % 50 == 0:
            print(f'keys of {i + 1}/{len(vid_reader)} frames')
    return torch.stack(keys), torch.stack(shrinkages), torch.stack(selections)


# ---------------------------------------------------------------------------
# deterministic augmentations
# ---------------------------------------------------------------------------

def _tv_inverse_matrix(center, angle, translate, scale, shear):
    """torchvision _get_inverse_affine_matrix (shear_y fixed at 0, as in the
    reference catalog): returns the 6 inverse-map coefficients."""
    rot = np.deg2rad(angle)
    sx = np.deg2rad(shear)
    cx, cy = center
    tx, ty = translate
    a = np.cos(rot)
    b = -np.cos(rot) * np.tan(sx) - np.sin(rot)
    c = np.sin(rot)
    d = -np.sin(rot) * np.tan(sx) + np.cos(rot)
    m = [d / scale, -b / scale, 0.0, -c / scale, a / scale, 0.0]
    m[2] += m[0] * (-cx - tx) + m[1] * (-cy - ty)
    m[5] += m[3] * (-cx - tx) + m[4] * (-cy - ty)
    m[2] += cx
    m[5] += cy
    return m


def _affine_pil(img: Image.Image, angle=0.0, translate=(0, 0), scale=1.0,
                shear=0.0, resample=Image.NEAREST) -> Image.Image:
    """torchvision F.affine PIL path: center-based inverse-map affine,
    including the NEAREST default interpolation (torchvision's default for
    F.affine/RandomAffine, which the reference catalog never overrides,
    frame_selection_utils.py:66-107)."""
    w, h = img.size
    m = _tv_inverse_matrix((w * 0.5, h * 0.5), angle, translate, scale, shear)
    return img.transform((w, h), Image.AFFINE, tuple(m), resample=resample)


def _gaussian_blur_tv(img: Image.Image, ksize: int = 7) -> Image.Image:
    """torchvision F.gaussian_blur semantics: truncated FIR kernel sampled at
    integer offsets with sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8, separable
    convolution with REFLECT padding, rounded back to uint8. (PIL's own
    GaussianBlur is an IIR approximation with different pixels; the
    reference uses the torchvision kernel, frame_selection_utils.py:58.)"""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float32) - (ksize - 1) * 0.5
    k1 = np.exp(-0.5 * (x / sigma) ** 2)
    k1 /= k1.sum()
    arr = np.asarray(img, np.float32)                       # [H, W, C]
    pad = ksize // 2
    arr = np.pad(arr, ((pad, pad), (pad, pad), (0, 0)), mode='reflect')
    # separable conv: rows then columns
    arr = np.apply_along_axis(
        lambda r: np.convolve(r, k1, mode='valid'), 1, arr)
    arr = np.apply_along_axis(
        lambda c: np.convolve(c, k1, mode='valid'), 0, arr)
    out = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    return Image.fromarray(out)


def _mask_affine(mask: np.ndarray, angle=0.0, translate=(0, 0), scale=1.0,
                 shear=0.0) -> np.ndarray:
    """Geometric transform of an [O, H, W] float mask, replicating the
    torchvision TENSOR affine exactly (half-pixel-center grid + nearest
    round, grid_sample padding zeros): the reference applies its mask_aug to
    a torch tensor (run_on_video.py:239), which takes torchvision's tensor
    path, a half-pixel off from the PIL path."""
    o, h, w = mask.shape
    m = _tv_inverse_matrix((0.0, 0.0), angle,
                           [float(t) for t in translate], scale, shear)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    bx = xs - (w - 1) * 0.5
    by = ys - (h - 1) * 0.5
    in_x = m[0] * bx + m[1] * by + m[2] + (w - 1) * 0.5
    in_y = m[3] * bx + m[4] * by + m[5] + (h - 1) * 0.5
    ix = np.round(in_x).astype(np.int64)
    iy = np.round(in_y).astype(np.int64)
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    out = np.zeros_like(mask)
    vy, vx = np.nonzero(valid)
    out[:, vy, vx] = mask[:, iy[vy, vx], ix[vy, vx]]
    return out


def _named(fn: Callable, name: str) -> Callable:
    fn.name = name
    return fn


def get_determenistic_augmentations(img_size=None, mask=None,
                                    subset: str = 'best_all'
                                    ) -> List[Tuple[Callable, Callable]]:
    """Returns (img_fn, mask_fn) pairs. img_fn: PIL RGB -> PIL RGB (raw image
    space); mask_fn: [O, H, W] float -> same. (Misspelling kept for API
    parity with the reference.)"""
    assert subset in {'best_3', 'best_3_with_symmetrical', 'best_all',
                      'original_only', 'all'}

    identity_mask = _named(lambda m: m, 'identity')

    bright = _named(lambda im: ImageEnhance.Brightness(im).enhance(1.5),
                    'bright')
    dark = _named(lambda im: ImageEnhance.Brightness(im).enhance(0.5), 'dark')
    gray = _named(lambda im: im.convert('L').convert('RGB'), 'gray')
    reduce_bits = _named(lambda im: ImageOps.posterize(im, 3), 'reduce_bits')
    sharp = _named(lambda im: ImageEnhance.Sharpness(im).enhance(16.0),
                   'sharp')
    blur = _named(lambda im: _gaussian_blur_tv(im, ksize=7), 'blur')

    def geo(name, **kw):
        return (_named(lambda im: _affine_pil(im, **kw), name),
                _named(lambda m: _mask_affine(m, **kw), name))

    rotate_right = geo('rotate_right', angle=30)
    rotate_left = geo('rotate_left', angle=-30)
    zoom_out = geo('zoom_out', scale=0.5)
    zoom_in = geo('zoom_in', scale=1.5)
    shear_right = geo('shear_right', shear=20)
    shear_left = geo('shear_left', shear=-20)
    if img_size is not None:
        translate_distance = img_size[-2] // 5  # W/5 (img_size = H, W, C)
    else:
        translate_distance = 200
    translate_right = geo('translate_right', translate=(translate_distance, 0))

    photometric = {
        'best_3': [blur],
        'best_3_with_symmetrical': [blur],
        'best_all': [bright, dark, reduce_bits, sharp, blur],
        'original_only': [bright, dark, gray, reduce_bits, sharp, blur],
        'all': [bright, dark, gray, reduce_bits, sharp, blur],
    }[subset]
    geometric = {
        'best_3': [zoom_in, shear_right],
        'best_3_with_symmetrical': [zoom_in, shear_right, shear_left],
        'best_all': [rotate_right, rotate_left, zoom_out, zoom_in,
                     shear_right, shear_left],
        'original_only': [],
        'all': [rotate_right, rotate_left, translate_right, zoom_out, zoom_in,
                shear_right, shear_left],
    }[subset]

    return ([(p, identity_mask) for p in photometric]
            + [(gi, gm) for gi, gm in geometric])
