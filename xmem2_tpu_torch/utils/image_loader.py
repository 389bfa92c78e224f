"""PaletteConverter — arbitrary-color masks -> index masks with a persistent
color->object lookup across frames.

Copy of xmem2_tpu/utils/image_loader.py (reference util/image_loader.py:
4-86). Black (index 0 after P-quantization) is background; new colors become
new object indices in order of first appearance.
"""

import numpy as np
from PIL import Image


class PaletteConverter:
    def __init__(self, palette: bytes, num_potential_colors: int = 256):
        self._palette = palette
        self._lookup = np.zeros(num_potential_colors, np.uint8)
        self._num_objects = 0

    def image_to_index_mask(self, img: Image.Image) -> Image.Image:
        img_p = img.convert('P')
        for _, c in img_p.getcolors():
            if c == 0:
                continue  # black is background
            if self._lookup[c] == 0:
                self._num_objects += 1
                self._lookup[c] = self._num_objects

        index_array = self._lookup[np.asarray(img_p)]
        index_mask = Image.fromarray(index_array, mode='P')
        index_mask.putpalette(self._palette)
        return index_mask

    @property
    def palette(self):
        return self._palette

    @property
    def lookup(self):
        return self._lookup

    @property
    def num_objects(self):
        return self._num_objects
