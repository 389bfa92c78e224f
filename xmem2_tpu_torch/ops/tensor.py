"""Padding utilities and soft aggregation.

Counterpart of xmem2_tpu/ops/tensor.py (reference util/tensor_util.py:47-77
and model/aggregate.py:6-17). pad_divide_by / unpad work on the two trailing
(spatial) dims, the torch layout [..., H, W]; the pad tuple is the reference's
(lw, uw, lh, uh).
"""

from typing import Tuple

import torch
import torch.nn.functional as F


def compute_pad(h: int, w: int, d: int) -> Tuple[int, int, int, int]:
    """Centered padding (lw, uw, lh, uh) making H, W multiples of d; the
    smaller half goes first (left/top)."""
    new_h = h + (d - h % d) % d
    new_w = w + (d - w % d) % d
    lh, uh = (new_h - h) // 2, (new_h - h) - (new_h - h) // 2
    lw, uw = (new_w - w) // 2, (new_w - w) - (new_w - w) // 2
    return (lw, uw, lh, uh)


def pad_divide_by(img: torch.Tensor, d: int):
    """Zero-pad [..., H, W] to multiples of d. Returns (padded, pad)."""
    pad = compute_pad(img.shape[-2], img.shape[-1], d)
    if not any(pad):
        return img, pad
    return F.pad(img, pad), pad


def unpad(img: torch.Tensor, pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """Inverse of pad_divide_by over [..., H, W]."""
    lw, uw, lh, uh = pad
    h, w = img.shape[-2:]
    return img[..., lh:h - uh, lw:w - uw]


def aggregate(prob: torch.Tensor, dim: int, return_logits: bool = False):
    """STM soft aggregation over the object dim: background probability is
    prod(1 - p_i); the stack is clamped and renormalised through a softmax of
    the logit transform."""
    bg = torch.prod(1.0 - prob, dim=dim, keepdim=True)
    new_prob = torch.cat([bg, prob], dim=dim).clamp(1e-7, 1.0 - 1e-7)
    logits = torch.log(new_prob / (1.0 - new_prob))
    out = torch.softmax(logits, dim=dim)
    if return_logits:
        return logits, out
    return out
