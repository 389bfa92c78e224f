"""Training augmentations (PIL/numpy, torchvision-free): a copy of
xmem2_tpu/train/augs.py, except that the TPS warp's resampling is numpy
(_remap_linear, _remap_nearest) in place of cv2.remap.

Behavioral targets: the transform stacks of reference dataset/vos_dataset.py
:51-95 and dataset/static_dataset.py:47-88 (ColorJitter, RandomGrayscale,
RandomAffine, RandomHorizontalFlip, RandomResizedCrop, Resize+RandomCrop).

Design difference from the reference: instead of re-seeding global RNGs so an
image/mask pair receives the same geometry (reference dataset/reseed.py), each
transform SAMPLES ITS PARAMETERS EXPLICITLY from a passed numpy Generator and
exposes `apply(img, params, ...)` — the same params are applied to the image
(bilinear/bicubic, im_mean fill) and the mask (nearest, 0 fill).
"""

import math
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance

IM_MEAN = (124, 116, 104)  # reference dataset/range_transform.py:3
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_INTERP = {
    'nearest': Image.NEAREST,
    'bilinear': Image.BILINEAR,
    'bicubic': Image.BICUBIC,
}


# ---------------------------------------------------------------------------
# color
# ---------------------------------------------------------------------------

def sample_color_jitter(rng: np.random.Generator, brightness=0.0, contrast=0.0,
                        saturation=0.0, hue=0.0):
    """torchvision ColorJitter convention: factor ~ U[max(0,1-v), 1+v];
    hue ~ U[-h, h]; applied in a random order."""
    def factor(v):
        return float(rng.uniform(max(0.0, 1 - v), 1 + v)) if v > 0 else None
    params = {
        'brightness': factor(brightness),
        'contrast': factor(contrast),
        'saturation': factor(saturation),
        'hue': float(rng.uniform(-hue, hue)) if hue > 0 else None,
        'order': rng.permutation(4).tolist(),
    }
    return params


def apply_color_jitter(img: Image.Image, params) -> Image.Image:
    ops = {
        0: ('brightness', lambda im, f: ImageEnhance.Brightness(im).enhance(f)),
        1: ('contrast', lambda im, f: ImageEnhance.Contrast(im).enhance(f)),
        2: ('saturation', lambda im, f: ImageEnhance.Color(im).enhance(f)),
        3: ('hue', _shift_hue),
    }
    for i in params['order']:
        name, fn = ops[i]
        if params[name] is not None:
            img = fn(img, params[name])
    return img


def _shift_hue(img: Image.Image, amount: float) -> Image.Image:
    """Shift hue by `amount` (fraction of the full cycle, torchvision range
    [-0.5, 0.5])."""
    hsv = np.array(img.convert('HSV'))
    hsv[..., 0] = (hsv[..., 0].astype(np.int32)
                   + int(round(amount * 255))) % 256
    return Image.fromarray(hsv, 'HSV').convert('RGB')


def maybe_grayscale(rng: np.random.Generator, p: float) -> bool:
    return bool(rng.random() < p)


def apply_grayscale(img: Image.Image) -> Image.Image:
    return img.convert('L').convert('RGB')


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def sample_affine(rng: np.random.Generator, degrees=0.0, scale=None,
                  shear=0.0, translate=None):
    return {
        'angle': float(rng.uniform(-degrees, degrees)) if degrees else 0.0,
        'scale': float(rng.uniform(*scale)) if scale else 1.0,
        'shear': float(rng.uniform(-shear, shear)) if shear else 0.0,
        'translate': (
            (float(rng.uniform(-translate[0], translate[0])),
             float(rng.uniform(-translate[1], translate[1])))
            if translate else (0.0, 0.0)),
    }


def apply_affine(img: Image.Image, params, interpolation='bilinear',
                 fill=0) -> Image.Image:
    """Center-based affine with torchvision FT.affine conventions."""
    w, h = img.size
    cx, cy = w * 0.5, h * 0.5
    a = math.radians(params['angle'])
    s = math.radians(params['shear'])
    sc = params['scale']
    m00 = sc * math.cos(a)
    m01 = -sc * math.sin(a + s) / max(math.cos(s), 1e-8)
    m10 = sc * math.sin(a)
    m11 = sc * math.cos(a + s) / max(math.cos(s), 1e-8)
    mat = np.array([[m00, m01], [m10, m11]])
    inv = np.linalg.inv(mat)
    tx, ty = params['translate']
    c0 = cx - inv[0, 0] * (cx + tx) - inv[0, 1] * (cy + ty)
    c1 = cy - inv[1, 0] * (cx + tx) - inv[1, 1] * (cy + ty)
    fillarg = tuple(fill) if isinstance(fill, (tuple, list)) else fill
    return img.transform(
        (w, h), Image.AFFINE,
        (inv[0, 0], inv[0, 1], c0, inv[1, 0], inv[1, 1], c1),
        resample=_INTERP[interpolation], fillcolor=fillarg)


def sample_hflip(rng: np.random.Generator, p: float = 0.5) -> bool:
    return bool(rng.random() < p)


def apply_hflip(img: Image.Image) -> Image.Image:
    return img.transpose(Image.FLIP_LEFT_RIGHT)


def sample_resized_crop(rng: np.random.Generator, in_size: Tuple[int, int],
                        scale=(0.36, 1.0), ratio=(3 / 4, 4 / 3), attempts=10):
    """torchvision RandomResizedCrop.get_params: sample an area fraction and
    aspect ratio; fall back to a center crop."""
    w, h = in_size
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(attempts):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = int(rng.integers(0, h - ch + 1))
            j = int(rng.integers(0, w - cw + 1))
            return {'top': i, 'left': j, 'height': ch, 'width': cw}
    # fallback: center crop at the closest valid aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return {'top': (h - ch) // 2, 'left': (w - cw) // 2,
            'height': ch, 'width': cw}


def apply_resized_crop(img: Image.Image, params, out_size: Tuple[int, int],
                       interpolation='bilinear') -> Image.Image:
    box = (params['left'], params['top'],
           params['left'] + params['width'], params['top'] + params['height'])
    return img.resize(out_size[::-1], resample=_INTERP[interpolation], box=box)


def resize_shorter(img: Image.Image, size: int, interpolation='bilinear') -> Image.Image:
    w, h = img.size
    if h <= w:
        nh, nw = size, max(1, int(size * w / h))
    else:
        nh, nw = max(1, int(size * h / w)), size
    return img.resize((nw, nh), resample=_INTERP[interpolation])


def sample_crop(rng: np.random.Generator, in_size: Tuple[int, int],
                out_size: Tuple[int, int]):
    """RandomCrop with pad_if_needed semantics: pad deltas decided by size."""
    w, h = in_size
    oh, ow = out_size
    pad_w = max(ow - w, 0)
    pad_h = max(oh - h, 0)
    w2, h2 = w + pad_w, h + pad_h
    return {
        'pad': (pad_w, pad_h),
        'top': int(rng.integers(0, h2 - oh + 1)),
        'left': int(rng.integers(0, w2 - ow + 1)),
    }


def apply_crop(img: Image.Image, params, out_size: Tuple[int, int],
               fill=0) -> Image.Image:
    oh, ow = out_size
    pad_w, pad_h = params['pad']
    if pad_w or pad_h:
        fillarg = tuple(fill) if isinstance(fill, (tuple, list)) else fill
        canvas = Image.new(img.mode, (img.width + pad_w, img.height + pad_h),
                           fillarg)
        canvas.paste(img, (pad_w // 2, pad_h // 2))
        img = canvas
    return img.crop((params['left'], params['top'],
                     params['left'] + ow, params['top'] + oh))


# ---------------------------------------------------------------------------
# thin-plate-spline warp (reference dataset/tps.py, external `thinplate` pkg)
# ---------------------------------------------------------------------------

def _tps_kernel(r2: np.ndarray) -> np.ndarray:
    return np.where(r2 == 0, 0.0, r2 * np.log(np.maximum(r2, 1e-12)) * 0.5)


def _tps_fit(c_src: np.ndarray, c_dst: np.ndarray) -> np.ndarray:
    """Fit TPS mapping dst control points -> src displacements (one spline per
    output coordinate). Returns [n+3, 2] parameters."""
    n = c_dst.shape[0]
    d2 = np.sum((c_dst[:, None] - c_dst[None]) ** 2, -1)
    K = _tps_kernel(d2)
    P = np.concatenate([np.ones((n, 1)), c_dst], 1)
    A = np.zeros((n + 3, n + 3))
    A[:n, :n] = K
    A[:n, n:] = P
    A[n:, :n] = P.T
    b = np.zeros((n + 3, 2))
    b[:n] = c_src - c_dst
    return np.linalg.solve(A + np.eye(n + 3) * 1e-9, b)


def _tps_grid(theta: np.ndarray, c_dst: np.ndarray, h: int, w: int):
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing='ij')
    pts = np.stack([ys.ravel(), xs.ravel()], 1)                  # [hw, 2]
    d2 = np.sum((pts[:, None] - c_dst[None]) ** 2, -1)            # [hw, n]
    U = _tps_kernel(d2)
    P = np.concatenate([np.ones((pts.shape[0], 1)), pts], 1)
    disp = U @ theta[:-3] + P @ theta[-3:]                        # [hw, 2]
    src = pts + disp
    map_y = (src[:, 0].reshape(h, w) * h).astype(np.float32)
    map_x = (src[:, 1].reshape(h, w) * w).astype(np.float32)
    return map_x, map_y


def _remap_linear(img: np.ndarray, map_x: np.ndarray,
                  map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR) of a uint8 image with
    the constant-0 border: bilinear weights in floating point, the sum
    rounded to the nearest integer, as OpenCV 5 computes it (OpenCV 4 rounds
    the coordinates to 1/32 of a pixel first, which moves a pixel of a noisy
    image by a few grey levels). Neighbours outside the image read 0."""
    h, w = img.shape[:2]
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    fx = (map_x - x0).astype(np.float64)
    fy = (map_y - y0).astype(np.float64)
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    # zero border: padded index i + 1 holds pixel i; 0 and w + 1 hold 0
    pad = np.pad(img, ((1, 1), (1, 1)) + ((0, 0),) * (img.ndim - 2))
    pad = pad.astype(np.float64)

    def at(dy, dx):
        return pad[np.clip(y0 + dy + 1, 0, h + 1),
                   np.clip(x0 + dx + 1, 0, w + 1)]

    acc = ((1 - fy) * ((1 - fx) * at(0, 0) + fx * at(0, 1))
           + fy * ((1 - fx) * at(1, 0) + fx * at(1, 1)))
    return np.rint(acc).astype(np.uint8)


def _remap_nearest(img: np.ndarray, map_x: np.ndarray,
                   map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, cv2.INTER_NEAREST), constant-0 border:
    coordinates rounded half to even (cvRound)."""
    h, w = img.shape[:2]
    x = np.rint(map_x).astype(np.int64)
    y = np.rint(map_y).astype(np.int64)
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    out = img[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)]
    out[~inside] = 0
    return out


def random_tps_warp(img: Image.Image, mask: Image.Image,
                    rng: np.random.Generator, scale: float = 0.02,
                    n_ctrl_pts: int = 12):
    """Random TPS warp applied identically to image (linear) and mask
    (nearest) — reference dataset/tps.py:23-37."""
    img_a = np.asarray(img)
    mask_a = np.asarray(mask)
    h, w = mask_a.shape[:2]
    y_idx = rng.choice(np.arange(h), size=n_ctrl_pts, replace=False) / h
    x_idx = rng.choice(np.arange(w), size=n_ctrl_pts, replace=False) / w
    c_src = np.stack([y_idx, x_idx], 1)
    c_dst = c_src + rng.normal(scale=scale, size=c_src.shape)
    theta = _tps_fit(c_src, c_dst)
    map_x, map_y = _tps_grid(theta, c_dst, h, w)
    warp_im = _remap_linear(img_a, map_x, map_y)
    warp_gt = _remap_nearest(mask_a, map_x, map_y)
    return Image.fromarray(warp_im), Image.fromarray(warp_gt)


def to_normalized_array(img: Image.Image) -> np.ndarray:
    """PIL RGB -> [H, W, 3] float32, ImageNet-normalized (final transform)."""
    x = np.asarray(img, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD
