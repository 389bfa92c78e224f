"""Segmentation palettes (reference util/palette.py equivalents).

The DAVIS palette is the standard PASCAL-VOC colormap (bit-interleaved,
generated); the YouTubeVOS palette is the 16-color list shipped with the
official YouTubeVOS tooling.
"""

import numpy as np


def voc_colormap(n: int = 256) -> np.ndarray:
    """Standard PASCAL VOC colormap: bits of the index spread across RGB."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


davis_palette_np = voc_colormap(256)
davis_palette = davis_palette_np.tobytes()

youtube_palette_np = np.array([
    [0, 0, 0], [236, 95, 103], [249, 145, 87], [250, 200, 99],
    [153, 199, 148], [98, 179, 178], [102, 153, 204], [197, 148, 197],
    [171, 121, 103], [255, 255, 255], [101, 115, 126], [11, 11, 11],
    [12, 12, 12], [13, 13, 13], [14, 14, 14], [15, 15, 15],
], np.uint8)
youtube_palette = youtube_palette_np.tobytes()
