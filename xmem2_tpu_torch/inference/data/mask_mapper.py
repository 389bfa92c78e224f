"""MaskMapper — index mask -> one-hot with non-continuous label remapping.

Behavioral parity target: reference inference/data/mask_mapper.py:7-64 (plus
dataset/util.py all_to_onehot). Two modes: default (new labels only,
YouTubeVOS-style) and exhaustive (index 0 is background, every pixel labeled).
"""

from typing import List, Tuple

import numpy as np


def all_to_onehot(mask: np.ndarray, labels: List[int]) -> np.ndarray:
    """[H, W] index mask -> [len(labels), H, W] one-hot
    (reference dataset/util.py:4)."""
    out = np.zeros((len(labels),) + mask.shape, np.uint8)
    for i, l in enumerate(labels):
        out[i] = (mask == l)
    return out


class MaskMapper:
    def __init__(self):
        self.labels: List[int] = []
        self.remappings: dict = {}
        self.coherent = True  # no mapping required while indices stay 1..n

    def convert_mask(self, mask: np.ndarray, exhaustive: bool = False
                     ) -> Tuple[np.ndarray, List[int]]:
        """mask: [H, W] index representation. Returns (one-hot float mask
        [num_objects, H, W], newly mapped labels)."""
        labels = np.unique(mask).astype(np.uint8)
        labels = labels[labels != 0].tolist()

        new_labels = list(set(labels) - set(self.labels))
        if not exhaustive:
            assert len(new_labels) == len(labels), \
                'Old labels found in non-exhaustive mode'

        for i, l in enumerate(new_labels):
            self.remappings[l] = i + len(self.labels) + 1
            if self.coherent and i + len(self.labels) + 1 != l:
                self.coherent = False

        if exhaustive:
            new_mapped_labels = list(range(1, len(self.labels) + len(new_labels) + 1))
        elif self.coherent:
            new_mapped_labels = new_labels
        else:
            new_mapped_labels = list(range(len(self.labels) + 1,
                                           len(self.labels) + len(new_labels) + 1))

        self.labels.extend(new_labels)
        onehot = all_to_onehot(mask, self.labels).astype(np.float32)
        return onehot, new_mapped_labels

    def remap_index_mask(self, mask: np.ndarray) -> np.ndarray:
        """Predicted continuous indices -> original label values
        (reference mask_mapper.py:56-64)."""
        if self.coherent:
            return mask
        new_mask = np.zeros_like(mask)
        for l, i in self.remappings.items():
            new_mask[mask == i] = l
        return new_mask
