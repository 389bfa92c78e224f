"""On-device post-processing: probability maps -> bit-packed index masks.

Counterpart of xmem2_tpu/inference/postprocess.py, with the same bit
layouts: the pack width adapts to the object count (1 bit/px for one object,
2 bits up to 3 objects, 4 bits up to 15, else 8); the first pixel of each
byte lands in the high bits and the width is padded to a byte boundary. Only
the packed mask crosses device->host.
"""

import numpy as np
import torch

from xmem2_tpu_torch.nn.functional import resize_bilinear


def mask_pack_bits(num_classes: int) -> int:
    """Smallest {1,2,4,8} bit width holding indices 0..num_classes-1
    (num_classes counts the background channel)."""
    if num_classes <= 2:
        return 1
    if num_classes <= 4:
        return 2
    if num_classes <= 16:
        return 4
    return 8


def prob_to_mask(prob: torch.Tensor, out_hw=None) -> torch.Tensor:
    """prob [C, H, W] -> uint8 index mask at out_hw (or native size):
    bilinear (align_corners=False) resize THEN argmax, as the reference."""
    if out_hw is not None and tuple(out_hw) != tuple(prob.shape[-2:]):
        prob = resize_bilinear(prob, tuple(out_hw))
    return torch.argmax(prob, dim=0).to(torch.uint8)


def prob_to_mask_packed(prob: torch.Tensor, out_hw=None) -> torch.Tensor:
    """prob_to_mask, bit-packed at mask_pack_bits(C) bits per pixel."""
    m = prob_to_mask(prob, out_hw)
    bits = mask_pack_bits(prob.shape[0])
    ppb = 8 // bits                          # pixels per byte
    if ppb == 1:
        return m
    pad = (-m.shape[1]) % ppb
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    packed = m[:, 0::ppb] << (8 - bits)
    for i in range(1, ppb):
        packed = packed | (m[:, i::ppb] << (8 - bits * (i + 1)))
    return packed


def unpack_mask(packed, width: int, bits: int = 4) -> np.ndarray:
    """Host inverse of prob_to_mask_packed: [H, ceil(W*bits/8)] ->
    [H, width]; `bits` is InferenceCore.pack_bits."""
    packed = np.asarray(packed)
    if bits == 8:
        return packed[:, :width]
    ppb = 8 // bits
    h, wb = packed.shape
    out = np.empty((h, wb * ppb), np.uint8)
    mask = (1 << bits) - 1
    for i in range(ppb):
        out[:, i::ppb] = (packed >> (8 - bits * (i + 1))) & mask
    return out[:, :width]
