"""The comparison that decides `correct` for the video cells: the masks the
program wrote as PNG files against the reference's labels."""

import os

import numpy as np
from PIL import Image


def read_labels(path: str, palette) -> np.ndarray:
    """A written RGB mask as label values: each pixel's colour looked up in
    the annotation palette (255 where a colour is in no entry)."""
    rgb = np.asarray(Image.open(path).convert('RGB')).astype(np.int64)
    code = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    out = np.full(code.shape, 255, np.uint8)
    pal = np.asarray(palette, np.int64).reshape(-1, 3)
    for label in np.unique(code):
        hit = np.nonzero((pal[:, 0] << 16 | pal[:, 1] << 8 | pal[:, 2])
                         == label)[0]
        if hit.size:
            out[code == label] = hit[0]
    return out


def confident_mismatch(mask_dir: str, record, palette, margin: float):
    """(share of all pixels of all frames where the reference's most
    probable class leads the runner-up by more than `margin` and the
    written mask names another label, share of all pixels that differ,
    frames read). Pixels the reference finds near a tie are left out of the
    first number: any rounding may flip them."""
    files = sorted(f for f in os.listdir(mask_dir) if f.endswith('.png'))
    if len(files) != len(record.labels):
        raise ValueError(f'{len(files)} masks written for '
                         f'{len(record.labels)} frames')
    return mismatch((read_labels(os.path.join(mask_dir, f), palette)
                     for f in files), record, margin)


def mismatch(labels, record, margin):
    """confident_mismatch over label maps [H, W], one a frame. margin: a
    number, or a tuple of them (then the first result is a tuple, one share
    a margin)."""
    margins = margin if isinstance(margin, tuple) else (margin,)
    bad = [0] * len(margins)
    diff = total = n = 0
    for got, ref, m in zip(labels, record.labels, record.margins):
        n += 1
        wrong = got != ref
        m = m.astype(np.float32)
        for i, t in enumerate(margins):
            bad[i] += int((wrong & (m > t)).sum())
        diff += int(wrong.sum())
        total += wrong.size
    shares = tuple(b / total for b in bad)
    return (shares if isinstance(margin, tuple) else shares[0]), \
        diff / total, n
